#!/usr/bin/env python3
"""Smoke run of wsl4mis_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--detail PATH]

Run from the repository root. It needs CUDA and the CUDA toolkit (nvcc);
without a card it exits 2 and prints no result. Phases, each fatal on
failure:

1. The card (nvidia-smi name and power limit), and the build of every
   kernel from ``wsl4mis_torch/csrc`` (timed). ptxas must report no spill
   in any conv, augment or GatedCRF kernel, every bf16 conv kernel's SASS
   (cuobjdump) must hold tensor-core instructions (HMMA / HGMMA; counts
   printed) and every f32 conv kernel's none (exact f32 on the CUDA
   cores).
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
   coordinates, and once with every feature read from memory; the fused
   ConvBlock layer, ops.bn_act, train and eval mode, forward and backward,
   at each of the 18 UNet BN layers' shapes at batch 24 (timed, repeated
   bit for bit) and at each distinct shape at batch 12 and 6, with its
   level's dropout on the encoder's first layer, and its eval forward at
   64 and 32: see check_bn_act). Off the
   paths, the conv
   also runs in all four roles at the ragged shapes of
   tests/test_torch_conv3x3.py (batch 2) and at 32->16, 256x256, batch 1;
   and every batch-24 conv launch (bf16 and f32) is repeated and must be
   bit-equal.
   The host time of one call of each conv and pool wrapper, the augment
   wrapper at batch 24, its S2L variant at 12 and the GatedCRF wrapper at
   batch 6 is recorded (wrapper_host_us), and one call of each runs under
   torch.cuda.set_sync_debug_mode("error"): a host-device sync fails the
   run. The batch-24 launches (the convs in bf16 and in f32, the pool in
   bf16; GatedCRF: batch 6, its training batch, and 24; f32; the S2L
   augment: batch 12) are timed:
   CUDA-event medians of 12 calls after 3 warm-up calls (the augment and
   GatedCRF calls also in a torch.profiler trace of 10 calls: the
   kernels alone, kernel_ms), for the kernel, its plain version and,
   where one PyTorch call
   computes the same function, that call (library_ms; the S2L augment's
   trace must hold augment_s2l_kernel alone, no fill-flag kernel; cuDNN's
   conv, in f32 with TF32 off, F.max_pool2d and its backward on a
   channels-last view; for the f32 convs also cuDNN under PyTorch's
   default TF32, library_tf32_ms, a lower precision). bound_ms
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
   the device's busy share). Last, the f32 cell (f32_cell):
   fully_supervised UNet b24 with compute_dtype float32, the f32 conv
   kernels' path: 4 eager steps launching per_step_counts a step and one
   captured 4-step call from the same state, bit-equal; 10 eager steps
   and the call in marked trace windows: ms/step, device busy ms and
   share, the conv kernels' traced ms a step beside their bound (the
   f32-cell line).
4. Reference: a full-width UNet in f32, batch 2, at 64x64 and at 128x128
   on three seeds: its eval logits and train-mode loss and gradients on
   the card (kernels) against the same model on the CPU (plain
   versions), beside the CPU's own gradient spread and a known-wrong
   variant (bf16 kernels); see reference_check for the tolerances.
5. The entry points (``python -m wsl4mis_torch.cli``) at full width on
   the phantoms: fully_supervised (batch 24) and dmpls (UNet_CCT, batch
   6) through the train command's parser over their scripts' defaults
   (with h5py, the whole command on an H5 tree of the same data; without
   it, its argv and config and the bundle from memory), validated before
   step 0, at half and at the end of the run: the final mean val Dice
   must reach its LEARN_RUNS bound and rise LEARN_RISE over the untrained
   one. The test command's configuration over each run's best
   checkpoint scores the val volumes (score_volumes): per-class Dice
   equal to the validation's that saved it (1e-6), HD95 and ASD finite,
   the NIfTI predictions read back bit for bit with their spacing. Then
   fully_supervised with --aug_mode host, 5 steps at batch 24 on slices
   of a native 212x232: its launches must hold no augment. Launch
   counters are zeroed before each run and each inference, and must show
   their expected counts.
6. The rest of the model zoo (last: phase 5 leaves cuDNN deterministic,
   which this phase resets): each 2D factory model (unet, unet_cct,
   unet_cct_3h, unet_ds, unet_urds, pnet, efficient_unet) at its published
   widths, 256x256, bf16, batch 24: eval forward and forward + backward
   timed by the port's measure_fwd_bwd_time (peak memory too), the
   multi-head UNets' K1-K3 and pool launches of one train-mode forward +
   backward against their shape's counts, and the model's f32 eval
   logits on the card against the CPU at batch 2 (ZOO_EVAL_TOL); each 3D
   net (net_factory_3d, published filters, 2 classes) timed at
   2x96x96x96, and its f32 logits and gradient against the CPU at 32^3;
   the train command with --model pnet / efficient_unet (fully_supervised
   batch 24, the second also with --encoder_weights from a file
   convert_torch_weights wrote from a synthesized state_dict) and pce
   --model pnet (batch 12): one augment launch a step, finite losses,
   ms/step and peak GB; the test command with --model unet_ds /
   unet_cct_3h on checkpoints carrying phase 5's trained UNet, and
   test_scribblevc ACDC's scoring on phase 3's ScribbleVC checkpoint and
   on a copy whose heads are shifted so that it predicts foreground: the
   per-class Dice equal to the validation's (difference 0.0).
7. Resuming a JAX run (under the train command's --deterministic 1 and
   PyTorch's deterministic algorithms):
   one method per layout of the JAX package's latest_full.ckpt at full
   width and its cell's batch: fully_supervised (batch 24), uamt (EMA
   params), deep_adversarial (the discriminator and its Adam), s2l (its
   weight buffer, on 1100 phantoms: (1100, 256, 256, 4) f32 is 1.07 GiB,
   written as flax's chunks) at batch 12 and scribblevc (AdamW, the class
   memory; batch 6). Each takes 2 steps (s2l: and a refresh sweep;
   scribblevc: up to the step after its memory gate opens), writes
   save_jax_train_state, restores it into a fresh bundle of another seed
   through restore_train_state (which must take the JAX format): every
   leaf bit-equal (parameters, BN statistics, optimizer state, step,
   extras); then both states take 2 more steps on the same batches and
   (seed, step) draws, which must leave them bit-equal, and launches of
   every run of steps must be its per-step counts. The same 2 steps run
   twice from the file without the deterministic algorithms must repeat
   bit for bit too (interp_axis's backward sums in a fixed order, so
   ScribbleVC's step is a function of its inputs in PyTorch's default
   mode). Then the train command (fully_supervised, batch 24)
   runs 3 steps, its latest_full.ckpt is rewritten in the JAX layout, and
   the command with --resume --max_iterations 7 must restore it (the log
   names the step and the format), take exactly steps 3..6 and write its
   checkpoints. The resume line holds the times, file sizes and peak
   memory.
8. Data parallelism (``wsl4mis_torch.parallel``; phases 1-7 run with no
   process group and must have issued no collective), each step held to the
   single-process step at the global batch from the same state: (a) two
   ranks, both on cuda:0 over gloo (NCCL takes one rank a card), in
   spawned processes, in f32 at full width: fully_supervised (batch 24),
   dmpls (6), uamt (12), s2l (12, its refresh sweep after the last step)
   and scribblevc (6, its memory gate open), 2 steps each: every step
   within tests/test_sharding.py's tolerances (dp_compare), the two ranks'
   states bit-equal after every step, each rank's launches its steps'
   counts; (b) fully_supervised at batch 24 in bf16 through the library
   API in a group of one NCCL rank, every collective an NCCL call: bit for
   bit the run with no group, its ms/step beside that run's; (c) with more
   than one card, min(4, cards) NCCL ranks, one a card, on
   fully_supervised against the single process, else a line saying it was
   not run. (a)'s group also runs phase 11's two host-fed cells, so that
   one spawn serves both phases. The data_parallel line holds each case's
   largest difference a leaf class, ms/step, collectives a step and the
   phase's seconds.
9. The rest of the JAX package's public surface (the surface line): (a)
   eval.test_single_volume with phase 5's trained UNet in bf16 over 4
   phantom volumes, each volume's [dice, hd95] equal to evaluate_fold's
   (difference 0.0), its launches an eval forward's per chunk, volumes
   per second; the same weights in f32 on the card against the CPU, the
   same class on at least 99.9% of the voxels; (b) models.init_model /
   apply_model on a UNet at batch 24: eval bit for bit the module's own
   forward (K1, K6 forward), train the same outputs and batch_stats (K2);
   (c) VNet with batchnorm, groupnorm and instancenorm, timed at
   2x96x96x96 in bf16 and held to the CPU in f32 at 32^3 (zoo_3d's
   tolerances; instancenorm's gradient beside the CPU's own spread over
   thread counts, surface_vnet); (d) utils.save_checkpoint of a card UNet's variables and a
   bf16 output, load_checkpoint into card tensors: bit for bit; (e)
   test_scribblevc ACDC --checkpoints over phase 3's checkpoint, phase
   6's shifted copy and a missing file: MISSING printed, the metrics equal
   to calculate_metric_percase_spacing at (10, 1, 1) over each one's own
   predictions.
10. The K-step call (``--steps_per_call``, engine.graph.CapturedStep;
   the captured line): for each of the 17 methods, at its phase-3 cell
   (fully_supervised, pce, pce_random_walker, pce_tv, pce_entropy_mini,
   pce_intensity_variance at batch 24, pce_mumford_shah, the semi
   family, deep_adversarial, ustm and s2l at 12, dmpls, pce_gatedcrf and
   scribblevc at 6), from one state, 4 eager steps and one 4-step call
   replaying the captured step end bit-equal in every leaf and in the
   metrics. The methods with variants (MethodBundle.variant, a graph
   each) cross them: s2l from thr_iter - 2 (after a refresh, so that the
   pseudo-label term is live), scribblevc from two steps before its memory
   gate opens, ustm over 12 steps (three calls) whose rotations take all
   four values, a graph captured earlier replayed after a later one. The
   wrappers' counters show each variant's warm-up and capture
   (WARMUP_STEPS + 1 steps' launches a graph), and a trace of 2 calls
   shows per_step_counts x 4 launches a call of every kernel (the same
   count over 8 eager steps checks the trace's reading); ms/step eager
   against captured (over 20 steps; scribblevc 8), device busy share,
   each variant's capture seconds and peak GB. The remat part
   (remat_part): ScribbleVC b6, 4 eager steps with remat bit-equal to 4
   without from one state across the memory gate, one captured 4-step
   remat call bit-equal to them, peak GB and captured ms/step with and
   without remat at batch 6 and 12, and the train_scribblevc ACDC command
   with --remat 1 --steps_per_call 4 over 8 steps (both variants
   captured) ending bit-equal to the same argv with --remat 0. Then the
   train command, fully_supervised batch 24, --steps_per_call 4
   --val_every 200 over 200 steps: the call captured, one validation at
   200 whose Dice equals phase 5's eager run of the same argv (the same
   state, bit for bit), the checkpoints. Last, --profile_steps 4 at K =
   2 (fs b24, 14 steps): the trace file holds the replays' kernels, 4
   steps' per_step_counts less at most one step's (a trace can lose the
   first launches after its window opens; phase 10's own windows read
   their launches between two marker kernels, after a padding step).
11. Host-fed batches (``device_data`` False, ``--device_data 0``) and
   debug_nans (the device_data line): for each of the 17 methods at its
   phase-3 cell (s2l and scribblevc from two steps before their gates),
   two bundles from one state, one staged and one host-fed (each batch's
   slices copied from pinned memory), 4 eager steps of each and one
   captured 4-step call of the host-fed one: 0 leaves and 0 metrics
   differing from the staged eager steps; the host-fed launches
   per_step_counts a step (a marked trace, padded by staged steps), and
   ms/step and busy share eager and captured (two marked segments of
   that trace). The
   train command, fully_supervised b24, --device_data 0 --steps_per_call
   4 over 200 steps: captured, its Dice equal to phase 5's and over
   LEARN_RUNS' bound. Two gloo ranks on cuda:0 with device_data 0 (uamt
   b12, scribblevc b6, one f32 step; each rank keeps its rows of the
   host batch, then copies them) held to one process as phase 8 holds
   them (run in phase 8's group, reported here). debug_nans
   (engine.debug_nans.NanCheck) on fs b24: 4 checked steps bit-equal to
   4 plain ones, the ms/step of each; a NaN in one input pixel raises
   FloatingPointError naming a module of the model, leaving the state as
   it was.

Output: detail lines, the entry points' line (entry-points: steps,
ms/step, Dice, seconds a part, the card), the zoo line (zoo: each
model's ms and checks, the card), the resume line (resume: each layout's
save and restore seconds, file MB, chunks, step differences, peak GB,
the card), the data_parallel line, the surface line, the captured
line, the device_data line, per-conv tables of the batch-24 step's conv
launches in bf16 (conv-table lines) and f32 (conv-table-f32), the f32
launches' sums per role (conv-f32-step), the per-kernel JSON line (the
conv kernels' f32 instantiations apart, with the f32 cell's launches; its
launches
summed over phases 3 and 5-11; phase 10's counted by the wrappers: the
warm-ups' and the captures'), the nvidia-smi line, and
last
{"ok": true, "device": {...}}. All records also go to one
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
import shutil
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
SVC_N = 6  # scribblevc's batch (bench.py's fifth config)
SVC_STEPS = 10
SVC_SLICES = 11  # one step an epoch at batch 6, so the memory gate (epoch >
                 # 4) opens at step 5 of the 10
SVC_REF_HW = 64  # the card-versus-CPU ScribbleVC check: f32, batch 2
FEATURES = (16, 32, 64, 128, 256)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SRC_CONV = "wsl4mis_torch/csrc/conv3x3.cu"
PALLAS_CONV = "wsl4mis_tpu/ops/pallas/banded_conv_pallas.py"
SRC_POOL = "wsl4mis_torch/csrc/maxpool.cu"
PALLAS_POOL = "wsl4mis_tpu/ops/pallas/maxpool_pallas.py"
SRC_BN = "wsl4mis_torch/csrc/bn_act.cu"
# the JAX package's BN, which XLA fuses with the LeakyReLU and dropout
BN_REPLACES = "wsl4mis_tpu/models/norm.py:31"
GCRF_RADIUS = 5
# device function names of the port's kernels, as a trace shows them: every
# __global__ of wsl4mis_torch/csrc (the conv's f32 CUDA-core kernels and its
# bf16 tensor-core ones apart)
PORT_KERNELS = ("conv3x3_fwd_kernel", "conv3x3_wgrad_kernel",
                "conv3x3_fwd_mma_kernel", "conv3x3_wgrad_mma_kernel",
                "augment_fill_kernel", "augment_kernel",
                "augment_s2l_kernel",
                "maxpool_fwd_kernel", "maxpool_bwd_kernel",
                "gated_crf_kernel", "gated_crf_fold_kernel",
                "bn_act_fwd_kernel", "bn_act_sums_kernel",
                "bn_act_bwd_kernel")
# the libraries whose ptxas report must show no spill
NO_SPILL = ("conv3x3", "augment", "gated_crf", "bn_act")
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


LIBRARY_KERNEL = re.compile(r"gemm|cutlass|xmma|cudnn|cublas|nvjet|"
                            r"convolve|fprop|dgrad|wgrad|splitk", re.I)


def kernel_classes(events, steps):
    """Device ms per step of the port's own kernels, of cuBLAS / cuDNN /
    CUTLASS products and convolutions (by kernel name) and of the rest
    (PyTorch's elementwise, reduction and copy kernels)."""
    out = {"port": 0.0, "library_matmul_conv": 0.0, "other": 0.0}
    for name, us in events:
        if any(k in name for k in PORT_KERNELS):
            key = "port"
        elif LIBRARY_KERNEL.search(name):
            key = "library_matmul_conv"
        else:
            key = "other"
        out[key] += 1e-3 * us / steps
    return out


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


def abs_err(got, want):
    return float((got.double() - want.double()).abs().max())


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


@contextlib.contextmanager
def cudnn_tf32(on):
    """cuDNN's TF32 switch set to `on`, the caller's setting put back
    after."""
    import torch

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def library_times(fn_l, dtype_name):
    """The PyTorch yardstick of a launch: library_ms, cuDNN in the
    launch's own precision (f32: TF32 off), and for f32 library_tf32_ms,
    the same call under PyTorch's default TF32 (10 mantissa bits: a lower
    precision than the kernel's, not an f32 time). None where no one call
    computes the function."""
    out = {"library_ms": None}
    if dtype_name == "float32":
        out["library_tf32_ms"] = None
    if fn_l is None:
        return out
    with cudnn_tf32(False):
        out["library_ms"] = time_ms(fn_l)
    if dtype_name == "float32":
        with cudnn_tf32(True):
            out["library_tf32_ms"] = time_ms(fn_l)
    return out



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
            with cudnn_tf32(False):  # the plain f32 version in f32
                rec["plain_ms"] = time_ms(fn_p)
            rec.update(library_times(fn_l, dtype_name))
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


def augment_record(case, maps, policy, timed, paths=()):
    """The augment kernel against its plain version: every pixel equal.
    maps: (images, labels) for K4, (images, scribbles, weights) for its
    S2L variant (every map filled with 0, no fill-flag kernel: a timed
    record's trace must show augment_s2l_kernel alone). paths: the
    training paths that launch it at this shape."""
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
           **({"paths": list(paths)} if paths else {}),
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


def check_augment(seed, b, timed, dev="cuda", s2l=False, case="path",
                  paths=()):
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
    return [augment_record(case, maps, policy, timed, paths)]


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


# the fused ConvBlock layer (ops.bn_act): the conv-output cotangent's error
# against the f64 version, bf16 in ulps (the final rounding's half ulp and
# the f32 sums' rounding), f32 relative to the largest magnitude; the scale
# and shift gradients' against f64, relative to the largest
BN_COT_ULP = 1.0
BN_COT_REL = 1e-5
BN_PARAM_REL = 1e-4
UNET_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


def unet_bn_layers():
    """(name, C, H, dropout) of the 18 UNet BN layers at 256x256: each
    ConvBlock's two, the encoder's first with its level's dropout."""
    f = FEATURES
    out = []
    for i, c in enumerate(f):
        out += [(f"enc{i}.bn1", c, HW >> i, UNET_DROPOUT[i]),
                (f"enc{i}.bn2", c, HW >> i, 0.0)]
    for i, c in enumerate((f[3], f[2], f[1], f[0])):
        out += [(f"up{i}.bn1", c, HW >> (3 - i), 0.0),
                (f"up{i}.bn2", c, HW >> (3 - i), 0.0)]
    return out


def bn_inputs(n, h, c, dtype_name, drop, dev="cuda"):
    """A BN layer's inputs at (n, h, h, c): y like a conv output and its f32
    moments, the scale and shift, running statistics, the dropout's draw
    (None without dropout) and an output cotangent g."""
    import torch

    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(c * 131 + h + n)
    y = (torch.randn((n, h, h, c), generator=gen, device=dev) * 0.7
         + 0.2).to(dt)
    yf = y.float()
    vec = [torch.randn((c,), generator=gen, device=dev) for _ in range(4)]
    u = (torch.rand((n, h, h, c), generator=gen, device=dev) if drop
         else None)
    g = torch.randn((n, h, h, c), generator=gen, device=dev).to(dt)
    return {"y": y, "s1": yf.sum((0, 1, 2)), "s2": (yf * yf).sum((0, 1, 2)),
            "scale": 1 + 0.2 * vec[0], "shift": 0.1 * vec[1],
            "mean": 0.1 * vec[2], "var": 1 + 0.1 * vec[3].abs(), "u": u,
            "g": g, "n": n * h * h, "keep": 1.0 - drop}


def bn_act_eager_grads(y, s1, s2, scale, shift, u, g, n, keep):
    """The eager chain's backward as autograd ran it (FusedBatchNorm,
    F.leaky_relu, the dropout, then _Conv3x3Stats' fold of the moments'
    cotangents): (the conv-output cotangent, the conv bias gradient, d
    scale, d shift)."""
    import torch

    from wsl4mis_torch.ops import bn_act as ba

    leaves = [t.detach().clone().requires_grad_()
              for t in (y, s1, s2, scale, shift)]
    ones = torch.ones_like(scale)
    out, _, _ = ba.bn_act_fwd_plain(leaves[0], leaves[1:3], *leaves[3:],
                                    ones, ones, u, n=n, keep=keep)
    gy, gs1, gs2, gsc, gsh = torch.autograd.grad(out, leaves, g)
    gout = (gy.float() + gs1 + 2.0 * y.float() * gs2).to(y.dtype)
    return gout, gout.float().sum((0, 1, 2)).to(y.dtype), gsc, gsh


def bn_act_grads_f64(y, s1, s2, scale, mask, fac, g, n, keep, eps=1e-5):
    """The backward in f64 from the compute-dtype g' and round(g' mul) that
    the kernels and the eager chain both form: the sums, the per-channel
    gradients and the cotangent unrounded. (cotangent, d scale, d shift)."""
    import torch

    from wsl4mis_torch.ops import bn_act as ba

    dims = (0, 1, 2)
    gp = ba.act_grad_plain(g, y, mask, fac, keep)
    gy = (gp * fac[3].to(y.dtype)).double()
    gpd, yd = gp.double(), y.double()
    g1, g2 = gpd.sum(dims), (gpd * yd).sum(dims)
    mean = s1.double() / n
    vun = s2.double() / n - mean * mean
    r = (vun.clamp(min=0) + eps).rsqrt()
    mul = scale.double() * r
    gmul = g2 - g1 * mean
    gvar = torch.where(vun >= 0, -0.5 * gmul * scale.double() * r ** 3,
                       torch.zeros_like(r))
    gmean = -g1 * mul - 2 * gvar * mean
    return gy + gmean / n + 2 * yd * (gvar / n), gmul * r, g1


def check_bn_act(name, c, h, drop, dtype_name, n, timed, dev="cuda",
                 eval_only=False, repeat=False):
    """The fused layer's kernels (ops.bn_act) at one shape (n, h, h, c)
    against their plain versions. Forward (train mode with the dropout at
    `drop`, and eval mode): the activation, the keep mask, the saved
    per-channel values and the updated running statistics bit-equal to the
    plain version, which is the eager chain op for op. Train backward: the
    conv-output cotangent within BN_COT_ULP bf16 ulps (f32: BN_COT_REL of
    the largest) of the f64 version and no farther from it than the eager
    chain's (f32, where both sum in f32: under BN_COT_REL / 10 counts as
    a tie), the bias gradient the rounded sum of the kernel's own
    cotangent, the scale and shift gradients within BN_PARAM_REL of f64.
    Eval backward (the running statistics constant, gs1 = gs2 = 0): the
    cotangent bit-equal to the plain version's, the bias, scale and shift
    gradients as in train mode. eval_only checks the eval forward alone
    (the validation's); repeat also checks that a second call of each
    kernel is bit-equal. If timed: each kernel's ms (CUDA events) and its
    device ms alone (kernel_ms, a torch.profiler trace of 10 calls) beside
    its plain version's ms and its bound (bytes), and the eager chain's
    backward (autograd and the fold) beside the two backward kernels.
    Returns records."""
    import torch

    from wsl4mis_torch.ops import bn_act as ba

    a = bn_inputs(n, h, c, dtype_name, drop, dev)
    y, u, g, cnt, keep = a["y"], a["u"], a["g"], a["n"], a["keep"]
    vec = (a["scale"], a["shift"])
    es = y.element_size()
    db_tol = 2.0 ** -8 if dtype_name == "bfloat16" else 1e-5
    recs = []

    def record(kernel, ok, err, nbytes, fn_k, fn_p, extra, timed=timed):
        rec = {"kernel": kernel, "layer": name, "dtype": dtype_name,
               "shape": [n, h, h, c], "dropout": drop, **extra,
               "max_abs_err": err, "ok": ok,
               **bound(nbytes, 10.0 * y.numel(), dtype_name)}
        if repeat:
            rec["repeat_bit_equal"] = bit_equal(fn_k(), fn_k())
        if timed:
            rec["ms"] = time_ms(fn_k)
            rec["kernel_ms"] = trace_ms(fn_k).get(kernel + "_kernel")
            rec["plain_ms"] = time_ms(fn_p)
            rec.update(library_times(None, dtype_name))
        recs.append(rec)
        print("kernel-check " + json.dumps(rec), flush=True)
        expect(ok and rec.get("repeat_bit_equal", True),
               f"{kernel} {name} {dtype_name} {rec['shape']}: {extra}, "
               f"repeat {rec.get('repeat_bit_equal')}")

    def fwd(fn, moments, stats):
        mean, var = (a["mean"].clone(), a["var"].clone()) if stats else (
            a["mean"], a["var"])
        out, mask, fac = fn(y, moments, *vec, mean, var,
                            u if moments else None, n=cnt, keep=keep,
                            update=stats)
        return out, mask, fac, mean, var

    def db_rel_err(db, gout):  # db against the sum of the kernel's gout
        own = gout.double().sum((0, 1, 2))
        return float(((db.double() - own).abs() / gout.double().abs().sum(
            (0, 1, 2)).clamp(min=1e-30)).max())

    # eval mode: the running statistics
    got = fwd(ba.bn_act_fwd, None, False)
    want = fwd(ba.bn_act_fwd_plain, None, False)
    same = {"out": bit_equal(got[0], want[0]),
            "fac": bit_equal(got[2], want[2])}
    record("bn_act_fwd", all(same.values()), abs_err(got[0], want[0]),
           2 * y.numel() * es,
           lambda: fwd(ba.bn_act_fwd, None, False)[0],
           lambda: fwd(ba.bn_act_fwd_plain, None, False)[0],
           {"role": "eval", "bit_equal": same}, timed=False)
    if eval_only:
        return recs
    # eval mode's backward: d scale, d shift from f64 sums of the g' both
    # versions form; the moments fed nothing (gs1 = gs2 = 0)
    fac = got[2]
    sums = ba.bn_act_sums(g, y, None, fac, a["scale"], n=1)
    zero = torch.zeros_like(sums[2])
    gout, db = ba.bn_act_bwd(g, y, None, fac, zero, zero)
    want_g = ba.bn_act_bwd_plain(g, y, None, want[2], zero, zero)[0]
    gp = ba.act_grad_plain(g, y, None, want[2], 1.0).double()
    g1, g2 = gp.sum((0, 1, 2)), (gp * y.double()).sum((0, 1, 2))
    r = (a["var"].double() + 1e-5).rsqrt()
    param_err = max(rel_max(sums[0], (g2 - g1 * a["mean"].double()) * r),
                    rel_max(sums[1], g1))
    record("bn_act_sums", param_err <= BN_PARAM_REL,
           abs_err(sums[1], g1), 2 * y.numel() * es,
           lambda: ba.bn_act_sums(g, y, None, fac, a["scale"], n=1),
           lambda: ba.bn_act_sums_plain(g, y, None, fac, a["scale"], n=1),
           {"role": "eval", "param_rel_err": param_err}, timed=False)
    db_err = db_rel_err(db, gout)
    record("bn_act_bwd", bit_equal(gout, want_g) and db_err <= db_tol,
           abs_err(gout, want_g), 3 * y.numel() * es,
           lambda: ba.bn_act_bwd(g, y, None, fac, zero, zero),
           lambda: ba.bn_act_bwd_plain(g, y, None, fac, zero, zero),
           {"role": "eval", "bit_equal": bit_equal(gout, want_g),
            "db_rel_err": db_err}, timed=False)
    # train mode: the batch's moments, folded into the running statistics
    moments = (a["s1"], a["s2"])
    got = fwd(ba.bn_act_fwd, moments, True)
    want = fwd(ba.bn_act_fwd_plain, moments, True)
    parts = ("out", "mask", "fac", "mean", "var")
    same = {k: (got[i] is None and want[i] is None)
            or bit_equal(got[i], want[i]) for i, k in enumerate(parts)}
    mbytes = (4 + 1) * y.numel() if drop else 0
    record("bn_act_fwd", all(same.values()), abs_err(got[0], want[0]),
           2 * y.numel() * es + mbytes,
           lambda: fwd(ba.bn_act_fwd, moments, True)[0],
           lambda: fwd(ba.bn_act_fwd_plain, moments, True)[0],
           {"role": "train", "bit_equal": same})
    _, mask, fac = got[:3]
    # backward: pass 1, the moments' cotangents, pass 2
    sums = ba.bn_act_sums(g, y, mask, fac, a["scale"], n=cnt, keep=keep)
    gout, db = ba.bn_act_bwd(g, y, mask, fac, sums[2], sums[3], keep=keep)
    want_g, want_scale, want_shift = bn_act_grads_f64(
        y, a["s1"], a["s2"], a["scale"], mask, fac, g, cnt, keep)
    eager = bn_act_eager_grads(y, a["s1"], a["s2"], *vec, u, g, cnt, keep)
    if dtype_name == "bfloat16":
        err, err_eager = ulp_err(gout, want_g), ulp_err(eager[0], want_g)
        ok = err <= min(BN_COT_ULP, err_eager)
    else:  # both sum in f32: under a tenth of the bound they tie
        err, err_eager = rel_max(gout, want_g), rel_max(eager[0], want_g)
        ok = err <= min(BN_COT_REL, max(err_eager, BN_COT_REL / 10))
    db_err = db_rel_err(db, gout)
    param_err = max(rel_max(sums[0], want_scale), rel_max(sums[1], want_shift))
    param_eager = max(rel_max(eager[2], want_scale),
                      rel_max(eager[3], want_shift))
    mread = y.numel() if drop else 0
    record("bn_act_sums", param_err <= BN_PARAM_REL,
           max(abs_err(sums[0], want_scale), abs_err(sums[1], want_shift)),
           2 * y.numel() * es + mread,
           lambda: ba.bn_act_sums(g, y, mask, fac, a["scale"], n=cnt,
                                  keep=keep),
           lambda: ba.bn_act_sums_plain(g, y, mask, fac, a["scale"], n=cnt,
                                        keep=keep),
           {"role": "train", "param_rel_err": param_err,
            "param_rel_err_eager": param_eager})

    def eager_bwd():
        return bn_act_eager_grads(y, a["s1"], a["s2"], *vec, u, g, cnt,
                                  keep)

    record("bn_act_bwd", ok and db_err <= db_tol, abs_err(gout, want_g),
           3 * y.numel() * es + mread,
           lambda: ba.bn_act_bwd(g, y, mask, fac, sums[2], sums[3],
                                 keep=keep),
           lambda: ba.bn_act_bwd_plain(g, y, mask, fac, sums[2], sums[3],
                                       keep=keep),
           {"role": "train", "err": err, "err_eager": err_eager,
            "err_unit": "ulp" if dtype_name == "bfloat16" else "rel",
            "db_rel_err": db_err,
            **({"eager_fwd_bwd_ms": time_ms(eager_bwd)} if timed else {})})
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
                    dev="cuda", stored_xy=False, paths=()):
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
           **({"paths": list(paths)} if paths else {}),
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
    from wsl4mis_torch.ops import augment, bn_act, conv3x3, gated_crf, maxpool

    return [m.launches for m in (conv3x3, augment, maxpool, gated_crf,
                                 bn_act)]


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


# the UNet family (ConvBlocks and 3x3 heads on the conv kernels, the
# encoder's pools on the pool kernels): its heads and decoders
UNET_HEADS = {"unet": 1, "unet_cct": 2, "unet_cct_3h": 3, "unet_ds": 4,
              "unet_urds": 4}
UNET_DECODERS = {"unet_cct": 2, "unet_cct_3h": 3}


def _unet_sizes(model_name):
    """(3x3 heads, ConvBlock convs, 3x3 convs) of a UNet-family model: the
    encoder's 10 ConvBlock convs, 8 a decoder, a head a decoder (UNet_DS /
    URDS: one a scale)."""
    heads = UNET_HEADS[model_name]
    blocks = 10 + 8 * UNET_DECODERS.get(model_name, 1)
    return heads, blocks, blocks + heads


def eval_counts(model_name):
    """Launches of one eval-mode forward without autograd: every conv a fwd
    launch, every ConvBlock conv's BN layer a fused forward, the encoder's
    four pools (ScribbleVC, PNet2D and EfficientNet-UNet: none, their
    convolutions and pools are cuDNN's and PyTorch's, as they are XLA's in
    the JAX package)."""
    if model_name not in UNET_HEADS:
        return {}
    _, blocks, convs = _unet_sizes(model_name)
    return {"conv3x3_fwd": convs, "maxpool_fwd": 4, "bn_act_fwd": blocks}


NO_BN_ACT = {"bn_act_fwd": 0, "bn_act_sums": 0, "bn_act_bwd": 0}


def per_step_counts(model_name, method=None, host_aug=False):
    """Expected launches per training step. A train-mode forward: every
    ConvBlock conv a stats launch, each head a fwd launch, the encoder's
    four pools, every ConvBlock conv's fused BN layer forward (bn_act); a
    backward: every conv but the stem a dgrad (fwd) launch, every conv a
    wgrad launch, four pool backwards, every fused BN layer's two backward
    passes; an eval forward: eval_counts. One augment launch (s2l: one of
    its S2L variant, which
    launches no fill-flag kernel; none with host augmentation, whose
    batches arrive augmented), and one GatedCRF contraction for
    pce_gatedcrf (its backward is an elementwise scale, no launch).
    ScribbleVC's step: one augment and one GatedCRF contraction, no conv
    or pool kernel; a PNet2D or EfficientNet-UNet step: the augment
    launch alone."""
    if model_name == "scribblevc":
        return {"conv3x3_fwd_stats": 0, "conv3x3_fwd": 0, "conv3x3_wgrad": 0,
                "augment": 1, "augment_s2l": 0, "maxpool_fwd": 0,
                "maxpool_bwd": 0, "gated_crf": 1, **NO_BN_ACT}
    if model_name not in UNET_HEADS:
        return {"conv3x3_fwd_stats": 0, "conv3x3_fwd": 0, "conv3x3_wgrad": 0,
                "augment": int(not host_aug), "augment_s2l": 0,
                "maxpool_fwd": 0, "maxpool_bwd": 0,
                "gated_crf": int(method == "pce_gatedcrf"), **NO_BN_ACT}
    fwd, bwd, evl = STEP_PASSES.get(method, (1, 1, 0))
    heads, blocks, convs = _unet_sizes(model_name)
    ev = eval_counts(model_name)
    return {"conv3x3_fwd_stats": blocks * fwd,
            "conv3x3_fwd": heads * fwd + (convs - 1) * bwd
            + ev["conv3x3_fwd"] * evl,
            "conv3x3_wgrad": convs * bwd,
            "augment": int(method != "s2l" and not host_aug),
            "augment_s2l": int(method == "s2l"),
            "maxpool_fwd": 4 * fwd + ev["maxpool_fwd"] * evl,
            "maxpool_bwd": 4 * bwd, "gated_crf": int(method == "pce_gatedcrf"),
            "bn_act_fwd": blocks * fwd + ev["bn_act_fwd"] * evl,
            "bn_act_sums": blocks * bwd, "bn_act_bwd": blocks * bwd}


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
    streams like its own). The semi-supervised methods, ustm, s2l and
    scribblevc build theirs with make_bundle (the semi family: data =
    (labeled, unlabeled), the paired stream over the staged [labeled;
    unlabeled]); the others as their build() does (with aug_mode "host",
    data needs its native slices: zoomed_with_native). With
    cfg.device_data False every stream ships its slices (s2l's and
    scribblevc's their own: data_stream)."""
    from wsl4mis_torch.engine.methods import get_method
    from wsl4mis_torch.engine.methods.common import (
        MethodBundle,
        make_model_and_state,
        paired_data,
        stage_dataset,
        train_batches,
    )

    mod = get_method(cfg.method)
    if cfg.method in SEMI:
        return (mod.make_bundle(cfg, *data, val),
                lambda: paired_data(cfg, *data)[1])
    if cfg.method in ("s2l", "scribblevc"):
        return (mod.make_bundle(cfg, data, val),
                lambda: mod.data_stream(cfg, data))
    if cfg.method == "ustm":
        bundle = mod.make_bundle(cfg, data, val)
    else:  # dmpls' build names its model; the others train cfg.model
        model, state = make_model_and_state(
            cfg, model_name="unet_cct" if cfg.method == "dmpls" else None)
        bundle = MethodBundle(
            model=model, state=state, step_fn=mod.make_step(cfg),
            data_iter=train_batches(cfg, data), val_volumes=val,
            steps_per_epoch=len(data) // cfg.batch_size,
            aux=stage_dataset(cfg, data))
    return bundle, lambda: train_batches(cfg, data)


def sup_type_of(method):
    if method == "pce_random_walker":
        return "random_walker"
    return ("label" if method == "fully_supervised" or method in SEMI
            else "scribble")


def svc_gate_step(n_slices, batch):
    """The first step at which ScribbleVC's memory gate (epoch > 4) is open
    on n_slices at `batch`."""
    return 5 * max(n_slices // batch, 1)


def run_method(method, model_name, batch, steps, validate, data, val,
               seed, time_steps=10, **flags):
    """Train `steps` steps through Trainer (flags: more TrainConfig fields)
    and check launches, losses and checkpoints; then, if time_steps, time
    and profile that many more steps. s2l: the host hook's refreshes enter
    the expected launches, and check_refresh checks and times one more.
    scribblevc: check_svc_run checks its memory, losses, predictors and
    inference checkpoint."""
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
    losses, vals = [], []
    terms = {"loss_u": [], "loss_cls": [], "loss_crf": []}
    svc = None
    if method == "scribblevc":  # the step after the first open one
        svc = {"decisions": {}, "after": svc_gate_step(len(data), batch) + 1}

    def recording_step(state, batch, rngs, aux=None):
        m = step_fn(state, batch, rngs, aux)
        losses.append(m["total_loss"])
        for k, v in terms.items():
            if k in m:
                v.append(m[k])
        if svc is not None and state.step == svc["after"]:
            svc["first_memory"] = {k: v.clone() for k, v in
                                   state.extra["class_memory"].items()}
        return m

    if svc is not None:  # count the validation's calls of both rules
        for name in ("predictor", "select_predictor"):
            pred = getattr(bundle, name)
            svc["decisions"][name] = 0

            def counted(out, fn=pred.decision_fn, name=name):
                svc["decisions"][name] += 1
                return fn(out)
            pred.decision_fn = counted

    bundle.step_fn = recording_step
    ema = state.extra["ema_params"] if method in EMA else {}
    ema_start = {k: v.clone() for k, v in ema.items()}
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    validate_fn = trainer.validate
    trainer.validate = lambda it: vals.append(validate_fn(it)) or vals[-1]
    if svc is not None:  # the select rule's per-class metrics (zoo phase)
        evaluate = trainer._evaluate

        def recording_eval(predictor, variables_fn):
            out = evaluate(predictor, variables_fn)
            if predictor is bundle.select_predictor:
                svc["select_val"] = out[0].tolist()
            return out
        trainer._evaluate = recording_eval

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
    if validate:  # a NaN-aware mean leaves hd95 NaN when nothing is found
        expect(len(vals) == 1 and np.isfinite(vals[0][0]) and (
            np.isfinite(vals[0][1]) or bundle.nan_val_metrics),
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
        rec["loss_u"] = [float(v) for v in terms["loss_u"]]
        rec["weight_max"] = float(state.extra["weight"].max())
        gated = rec["loss_u"][cfg.thr_iter:]
        expect(rec["weight_max"] > 0 and gated and all(v > 0 for v in gated),
               f"s2l: weight buffer max {rec['weight_max']}, loss_u after "
               f"step {cfg.thr_iter}: {gated}")
        rec["refresh"] = check_refresh(bundle, cfg, model_name)
    if svc is not None:
        rec.update(check_svc_run(bundle, cfg, steps, terms, svc))
        rec["select_val"] = svc["select_val"]
        rec["snapshot"] = {k: getattr(cfg, k) for k in (
            "snapshot_root", "exp", "fold", "sup_type")}

    if time_steps:
        it = new_batches()
        rec.update(time_step(step_fn, state, bundle.aux, cfg,
                             [next(it) for _ in range(time_steps)], seed))
    rec["run_s"] = time.perf_counter() - start
    print("slice-run " + json.dumps(rec), flush=True)
    return rec


def check_svc_run(bundle, cfg, steps, terms, svc):
    """After a ScribbleVC run: the gate opened inside it, the memory is
    initialized and moved after its first update, loss_cls and loss_crf
    are finite, the validation ran both rules (the CAM rule with the
    memory, the mean-softmax rule without), and the inference checkpoint
    holds the memory as it stands."""
    import numpy as np
    import torch

    memory = bundle.state.extra["class_memory"]
    gate = svc_gate_step(len(bundle.aux["images"]), cfg.batch_size)
    first = svc.get("first_memory")
    moved = (max(float((memory[k] - first[k]).abs().max())
                 for k in ("hist_conv", "hist_tran"))
             if first is not None else 0.0)
    ckpt = torch.load(os.path.join(cfg.snapshot_path, f"iter_{steps}.pth"),
                      map_location="cpu", weights_only=True)
    saved = ckpt.get("class_memory", {})
    rec = {"gate_step": gate,
           "memory": {"initialized": float(memory["initialized"]),
                      "hist_conv_absmax": float(memory["hist_conv"].abs()
                                                .max()),
                      "hist_tran_absmax": float(memory["hist_tran"].abs()
                                                .max()),
                      "moved_after_first_update": moved},
           "loss_cls": [float(v) for v in terms["loss_cls"]],
           "loss_crf": [float(v) for v in terms["loss_crf"]],
           "decision_calls": svc["decisions"],
           "checkpoint_keys": sorted(ckpt),
           "checkpoint_memory_equal": bool(saved) and all(
               torch.equal(saved[k], memory[k].cpu()) for k in memory)}
    expect(0 < gate < steps, f"scribblevc: gate at step {gate} of {steps}")
    expect(rec["memory"]["initialized"] == 1.0 and moved > 0
           and rec["memory"]["hist_conv_absmax"] > 0,
           f"scribblevc: memory {rec['memory']}")
    expect(len(rec["loss_cls"]) == len(rec["loss_crf"]) == steps
           and all(np.isfinite(rec["loss_cls"] + rec["loss_crf"])),
           f"scribblevc: loss_cls {rec['loss_cls']}, loss_crf "
           f"{rec['loss_crf']}")
    expect(all(v > 0 for v in svc["decisions"].values()),
           f"scribblevc: validation decisions {svc['decisions']}")
    expect(rec["checkpoint_memory_equal"],
           f"scribblevc: iter_{steps}.pth holds {rec['checkpoint_keys']}")
    return {"svc": rec}


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
            "ms_per_step_by_class": kernel_classes(events, steps),
            "device_busy_ms_per_step": 1e-3 * busy_us / steps,
            "device_busy_share": busy_us / wall_us,
            "top_kernels_ms_per_step": [[name[:80], 1e-3 * us / steps]
                                        for name, us in rows[:top]]}


F32_EAGER = 10  # the f32 cell's eager steps in its traced window
F32_K = 4  # the f32 cell's captured call: steps (phase 10's CAPTURE_K)


def conv_trace_ms(events, steps):
    """Device ms a step of the conv kernels among a trace's device events,
    by launch counter (TRACE_KERNELS' names: the forward with moments, the
    forward, the weight gradient) and in all."""
    out = {k: 0.0 for k in CONV_KERNELS}
    for name, us in events:
        for key, pattern in TRACE_KERNELS:
            if re.search(pattern, name):
                if key in out:
                    out[key] += 1e-3 * us / steps
                break
    out["all"] = sum(out.values())
    return out


def f32_cell(seed, data, card, bound_ms, dev="cuda", hw=HW, batch=N,
             steps=F32_EAGER, k=F32_K):
    """Phase 3's f32 cell: fully_supervised UNet at `batch` with
    compute_dtype float32, the f32 conv kernels' path. After a warm-up
    step, from one state: k eager steps, whose launches must be
    per_step_counts a step, and one k-step call of engine.graph.
    CapturedStep on the same batches, every leaf and metric bit-equal to
    them. Then `steps` eager steps and the call as two marked segments of
    one trace: ms/step, device busy ms and share, and the conv kernels'
    device ms a step (by role and in all) beside bound_ms, the least time
    of the step's conv launches; the launches of the whole cell, which the
    kernels line's f32 entries report. On the CPU (the tests) the eager
    steps alone."""
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.graph import CapturedStep
    from wsl4mis_torch.engine.methods.common import split_rngs

    t_run = time.perf_counter()
    cfg = TrainConfig(
        method="fully_supervised", model="unet", batch_size=batch,
        max_iterations=10 ** 4, compute_dtype="float32", seed=seed,
        device=dev, patch_size=(hw, hw), sup_type="label")
    bundle, new_batches = method_bundle(cfg, data, None)
    state, step_fn, aux = bundle.state, bundle.step_fn, bundle.aux
    it = new_batches()
    batches = [next(it) for _ in range(k)]

    def eager(n):
        for i in range(n):
            m = step_fn(state, batches[i % k],
                        split_rngs(seed, state.step, dev), aux)
        return m

    reset_counts()
    eager(1)  # cuDNN's and cuBLAS's first calls
    start = _snapshot(state_leaves(state))
    before = launch_counts()
    want_metrics = _metrics_leaves(eager(k))
    sync(dev)
    step_launches = {key: v - before[key]
                     for key, v in launch_counts().items()}
    want = _snapshot(state_leaves(state))
    per = per_step_counts("unet", "fully_supervised")
    rec = {"card": card, "batch": batch, "k": k, "leaves": len(want),
           "step_launches": step_launches,
           "expected_step_launches": {key: v * k for key, v in per.items()},
           "conv_bound_ms": bound_ms}
    bad, worst, bad_metrics = [], 0.0, []
    if dev == "cuda":
        _restore(state, start)
        captured = CapturedStep(step_fn, state, aux, seed, bundle.variant)
        got_metrics = _metrics_leaves(captured(batches))
        sync(dev)
        bad, worst = leaves_diff(want, _snapshot(state_leaves(state)))
        bad_metrics = sorted(key for key, v in want_metrics.items()
                             if not torch.equal(v, got_metrics[key]))
        (ev_eager, prof_eager), (ev_cap, prof_cap) = traced_windows(
            [(None, lambda: eager(steps), steps),
             (None, lambda: captured(batches), k)], lambda: eager(1))
        rec.update(
            eager={**prof_eager, "steps": steps,
                   "conv_ms_per_step": conv_trace_ms(ev_eager, steps),
                   "trace_launches": trace_launches(ev_eager)},
            captured={**prof_cap, "steps": k,
                      "conv_ms_per_step": conv_trace_ms(ev_cap, k),
                      "trace_launches": trace_launches(ev_cap)},
            capture_s=sum(captured.capture_s.values()))
        del captured
    rec.update(leaves_differing=bad, max_abs_diff=worst,
               metrics_differing=bad_metrics, launches=launch_counts(),
               run_s=time.perf_counter() - t_run)
    print("f32-cell " + json.dumps(rec), flush=True)
    expect(step_launches == rec["expected_step_launches"],
           f"f32 cell: {k} eager steps launched {step_launches}, not "
           f"{k} x {per}")
    expect(not bad and not bad_metrics,
           f"f32 cell: the captured call differs from {k} eager steps in "
           f"{bad[:8]} (max {worst}) and metrics {bad_metrics}")
    traced = {part: rec.get(part, {}).get("trace_launches")
              for part in ("eager", "captured")}
    expect(dev != "cuda" or (
        traced["eager"] == {key: v * steps for key, v in per.items()}
        and traced["captured"] == rec["expected_step_launches"]),
        f"f32 cell: traced launches {traced['eager']} over {steps} eager "
        f"steps, {traced['captured']} over the {k}-step call, against "
        f"{per} a step")
    return rec


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


def svc_case(seed, hw, **model_kwargs):
    """(model, x, scribbles, category): a ScribbleVC in f32 (full width
    unless model_kwargs narrow it), batch 2, drop-path 0 (train mode makes
    no draw), memory off, and two phantom slices at hw x hw with their
    scribbles and class-presence table. The BN running statistics are
    those of x (a no-grad train forward at momentum 0): at their initial
    (0, 1) the eval forward normalises nothing and its activations grow
    through the 12 stages."""
    import torch

    from wsl4mis_torch.data import synthetic_slices
    from wsl4mis_torch.engine.methods.scribblevc import slice_categories
    from wsl4mis_torch.models import FusedBatchNorm, net_factory

    model = net_factory("scribblevc", 4, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(seed),
                        batch_size=2, drop_path_rate=0.0, **model_kwargs)
    data = synthetic_slices(2, (hw, hw), seed=seed, sup_type="scribble")
    x = torch.from_numpy(data.images[..., None])
    lab = torch.from_numpy(data.labels)
    cat = torch.from_numpy(slice_categories(data.dense_labels, 4))
    norms = [m for m in model.modules() if isinstance(m, FusedBatchNorm)]
    for m in norms:
        m.momentum = 0.0
    with torch.no_grad():
        model(x, train=True)
    for m in norms:
        m.momentum = 0.9
    return model, x, lab, cat


def svc_loss_and_grads(model, x, lab, cat):
    """Train-mode pCE of both decoders plus the BCE of both heads (the
    step's terms that need no kernel), and every parameter's gradient."""
    import torch.nn.functional as F

    from wsl4mis_torch.ops import losses

    model.zero_grad()
    seg_conv, seg_trans, (conv_cls, tran_cls) = model(x, train=True)
    loss = 0.5 * (losses.cross_entropy(seg_conv, lab, ignore_index=4)
                  + losses.cross_entropy(seg_trans, lab, ignore_index=4)) \
        + 0.05 * (F.binary_cross_entropy_with_logits(conv_cls, cat)
                  + F.binary_cross_entropy_with_logits(tran_cls, cat))
    loss.backward()
    return loss.item(), {k: p.grad.detach().float().cpu()
                         for k, p in model.named_parameters()}


def grad_norm_err(got, want):
    """The norm of the gradient difference over all parameters, over the
    norm of `want`: one number for the whole gradient vector, which the
    tensors whose true gradient is 0 (a bias in front of a train-mode BN,
    pure rounding noise) do not dominate."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / den) ** 0.5


# between the card's error and the exact-GELU variant's on an H100 (card
# 5.8e-5 / 6.0e-3, wrong 1.7e-3 / 0.20, the CPU's own gradient spread up to
# 3.6e-2: PERF.md, the ScribbleVC findings)
SVC_EVAL_TOL = 3e-4
SVC_LOSS_TOL = 1e-4
SVC_GRAD_TOL = 0.1


def svc_reference_check(seed, dev="cuda", hw=SVC_REF_HW, draws=2,
                        **model_kwargs):
    """ScribbleVC in f32 (TF32 off) on `dev` against the same model on the
    CPU: the four eval outputs (both decoders' logits, both heads), the
    train-mode loss and the whole gradient, beside the CPU's own spread
    (the batch reversed, and `draws` input scalings by 1 + 1e-6 noise, which
    change only f32 rounding) and a known-wrong variant (exact GELU in
    place of flax's tanh form) on `dev`. Tolerances: eval outputs
    SVC_EVAL_TOL of their largest magnitude, loss SVC_LOSS_TOL relative,
    gradient SVC_GRAD_TOL in norm (grad_norm_err), which the CPU's spread
    must lie under (train-mode BN over the 4x4 deep maps at batch 2
    amplifies rounding) and the wrong variant above, in both checks."""
    import copy

    import torch

    import wsl4mis_torch.models.scribblevc as svc_model

    cpu, x, lab, cat = svc_case(seed, hw, **model_kwargs)
    card = copy.deepcopy(cpu).to(dev)
    xd, ld, cd = x.to(dev), lab.to(dev), cat.to(dev)
    with torch.no_grad():
        want = cpu(x, train=False)
        got = card(xd, train=False)
    flat = (lambda o: [o[0], o[1], o[2][0], o[2][1]])
    eval_errs = [rel_max(g.cpu(), w) for g, w in zip(flat(got), flat(want))]
    loss_c, grad_c = svc_loss_and_grads(cpu, x, lab, cat)
    loss_g, grad_g = svc_loss_and_grads(card, xd, ld, cd)
    _, grad_rev = svc_loss_and_grads(cpu, x.flip(0), lab.flip(0),
                                     cat.flip(0))
    gen = torch.Generator().manual_seed(seed)
    perturb = 0.0
    for _ in range(draws):
        noise = torch.randn(x.shape, generator=gen)
        _, g_p = svc_loss_and_grads(cpu, x * (1 + 1e-6 * noise), lab, cat)
        perturb = max(perturb, grad_norm_err(g_p, grad_c))
    gelu = svc_model._gelu
    svc_model._gelu = torch.nn.functional.gelu
    try:
        with torch.no_grad():
            wrong = card(xd, train=False)
        _, grad_w = svc_loss_and_grads(card, xd, ld, cd)
    finally:
        svc_model._gelu = gelu
    rec = {"input": [2, hw, hw, 1], "seed": seed, "device": str(dev),
           "eval_rel_err": eval_errs,
           "loss": loss_c, "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
           "grad_norm_err": grad_norm_err(grad_g, grad_c),
           "cpu_reorder_err": grad_norm_err(grad_rev, grad_c),
           "cpu_perturb_err": perturb,
           "wrong_variant_eval_err": max(
               rel_max(g.cpu(), w) for g, w in zip(flat(wrong), flat(want))),
           "wrong_variant_grad_err": grad_norm_err(grad_w, grad_c),
           "finite": all(bool(torch.isfinite(o).all()) for o in flat(got)),
           "shapes": [list(o.shape) for o in flat(got)]}
    print("svc-reference " + json.dumps(rec), flush=True)
    expect(rec["finite"] and rec["shapes"] == [[2, hw, hw, 4]] * 2
           + [[2, 3]] * 2, f"svc reference: outputs {rec['shapes']}")
    expect(max(eval_errs) <= SVC_EVAL_TOL,
           f"svc reference: eval rel err {eval_errs}")
    expect(rec["loss_rel_err"] <= SVC_LOSS_TOL,
           f"svc reference: loss rel err {rec['loss_rel_err']}")
    expect(max(rec["cpu_reorder_err"], perturb) <= SVC_GRAD_TOL,
           f"svc reference: the CPU's own spread exceeds {SVC_GRAD_TOL}")
    expect(rec["grad_norm_err"] <= SVC_GRAD_TOL,
           f"svc reference: grad err {rec['grad_norm_err']}")
    expect(rec["wrong_variant_eval_err"] > SVC_EVAL_TOL
           and rec["wrong_variant_grad_err"] > SVC_GRAD_TOL,
           f"svc reference: exact GELU passes the check (eval "
           f"{rec['wrong_variant_eval_err']}, gradient "
           f"{rec['wrong_variant_grad_err']})")
    return rec


# ---- phase 5: the entry points ----------------------------------------------

# (script, model, batch, steps, final mean val Dice bound) of the learning
# check: fully_supervised and dmpls through the train command line, on the
# phantoms, a validation at half and at the end of each run. Each bound
# sits below the card's Dice and the JAX package's on the CPU from the
# same initial weights (PERF.md; tools/jax_learning_check.py).
LEARN_RUNS = (
    ("train_fully_supervised_2D", "unet", N, 200, 0.9),
    ("train_weakly_supervised_segmentation_pCE_ours_proposed", "unet_cct",
     DMPLS_N, 300, 0.5),
)
LEARN_RISE = 0.3  # the final Dice over the untrained one, at the least
HOST_AUG_STEPS = 5
HOST_AUG_NATIVE = (212, 232)  # the host-augmented slices' native size


def entry_argv(batch, steps, val_every, snap_root, seed, hw=HW):
    """The flags of a train command line over a script's defaults, less
    --device (the JAX package's has none): batch, steps (the poly LR's
    horizon too), the validation cadence, one checkpoint at the end."""
    return ["--batch_size", str(batch), "--max_iterations", str(steps),
            "--val_every", str(val_every), "--ckpt_every", str(steps),
            "--log_every", str(max(steps // 4, 1)), "--seed", str(seed),
            "--snapshot_root", snap_root, "--patch_size", f"[{hw}, {hw}]"]


def write_h5_tree(root, dense, scribble, val, fold):
    """An ACDC H5 tree of in-memory slices (label and scribble keys, ten
    slices a train patient of `fold`) and volumes (one a test patient)."""
    import h5py
    import numpy as np

    from wsl4mis_torch.data import fold_ids

    train_ids, test_ids = fold_ids(fold)
    os.makedirs(os.path.join(root, "ACDC_training_slices"), exist_ok=True)
    os.makedirs(os.path.join(root, "ACDC_training_volumes"), exist_ok=True)
    for i in range(len(dense)):
        name = f"{train_ids[i // 10]}_frame01_slice_{i % 10}.h5"
        with h5py.File(os.path.join(root, "ACDC_training_slices", name),
                       "w") as f:
            f["image"] = dense.images[i]
            f["label"] = dense.labels[i].astype(np.uint8)
            f["scribble"] = scribble.labels[i].astype(np.uint8)
    for case, vol in zip(test_ids, val):
        with h5py.File(os.path.join(root, "ACDC_training_volumes",
                                    f"{case}_frame01.h5"), "w") as f:
            f["image"] = vol["image"]
            f["label"] = vol["label"].astype(np.uint8)
    return root


def cli_trainer(script, argv, data, val, tree=None):
    """The Trainer of `python -m wsl4mis_torch.cli train <script> argv`:
    with an H5 tree (h5py present), the command's own (cli.make_trainer,
    the bundle read from the tree); else the same argv through the
    command's parser and config, the bundle from in-memory data."""
    from wsl4mis_torch import cli
    from wsl4mis_torch.engine.trainer import Trainer

    method, defaults = cli.resolve_script(script)
    if tree is not None:
        return cli.make_trainer(method, defaults, argv + ["--root_path", tree])
    args = cli.build_parser(defaults).parse_args(argv)
    cfg = cli.config_from_args(args, method)
    cli.set_deterministic(args.deterministic)
    bundle, _ = method_bundle(cfg, data, val)
    return Trainer(cfg, bundle, use_tensorboard=False)


def sync(dev):
    import torch

    if dev == "cuda":
        torch.cuda.synchronize()


def run_cli(script, model_name, argv, data, val, tree=None, dev="cuda"):
    """Train through the command line; check the launches (a host-augmented
    run: no augment launch), finite losses and the checkpoints; record the
    mean val Dice before step 0 and the per-class metrics of every
    validation."""
    import numpy as np

    trainer = cli_trainer(script, argv, data, val, tree)
    cfg, bundle = trainer.cfg, trainer.bundle
    before = trainer._evaluate(trainer.predictor, bundle.val_variables)[1]
    evals, losses = [], []
    evaluate, step_fn = trainer._evaluate, bundle.step_fn

    def recording_eval(predictor, variables_fn):
        t0 = time.perf_counter()
        out = evaluate(predictor, variables_fn)
        evals.append((out[0], time.perf_counter() - t0))
        return out

    def recording_step(state, batch, rngs, aux=None):
        m = step_fn(state, batch, rngs, aux)
        losses.append(m["total_loss"])
        return m

    trainer._evaluate, bundle.step_fn = recording_eval, recording_step
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    trainer.train()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = cfg.max_iterations
    host = cfg.aug_mode == "host"
    expected = {k: v * steps for k, v in per_step_counts(
        model_name, cfg.method, host_aug=host).items()}
    depth = sum(-(-v["image"].shape[0] // 8) * 8 for v in bundle.val_volumes)
    for k, v in eval_counts(model_name).items():
        expected[k] += v * -(-depth // EVAL_N) * len(evals)
    loss_vals = [float(v) for v in losses]
    dice = [float(m[:, 0].mean()) for m, _ in evals]
    val_s = sum(s for _, s in evals)
    rec = {"script": script, "method": cfg.method, "batch": cfg.batch_size,
           "steps": steps, "aug_mode": cfg.aug_mode, "launches": counts,
           "expected": expected, "losses": loss_vals,
           "dice_before": before, "val_dice": dice,
           "val_per_class": [m.tolist() for m, _ in evals],
           "wall_s": wall, "val_s": val_s,
           "ms_per_step": 1e3 * (wall - val_s) / steps}
    expect(counts == expected,
           f"{script}: launches {counts} != {expected}")
    expect(len(loss_vals) == steps and all(np.isfinite(loss_vals)),
           f"{script}: losses {loss_vals}")
    names = [f"iter_{steps}.pth", "latest_full.ckpt"]
    if evals:
        names.append(f"{cfg.model}_best_model.pth")
    for name in names:
        expect(os.path.isfile(os.path.join(cfg.snapshot_path, name)),
               f"{script}: checkpoint {name} missing")
    return trainer, rec, [m for m, _ in evals]


def check_inference(trainer, evals, model_name, dev="cuda"):
    """The test command's configuration over the run's
    {model}_best_model.pth, scored on the run's val volumes (score_volumes,
    which inference_fold runs on the volumes it reads): per-class Dice
    equal to the validation's that saved the checkpoint (1e-6), HD95 and
    ASD finite, every _pred.nii.gz equal to the prediction with the spacing
    written; the launches one eval forward a 64-slice chunk."""
    import numpy as np

    from wsl4mis_torch import cli
    from wsl4mis_torch.data import read_nifti
    from wsl4mis_torch.eval.infer import (
        checkpoint_path,
        load_model,
        score_volumes,
    )

    cfg = trainer.cfg
    icfg = cli.inference_config(cli.test_parser().parse_args([
        "--exp", cfg.exp, "--model", cfg.model, "--fold", cfg.fold,
        "--sup_type", cfg.sup_type, "--snapshot_root", cfg.snapshot_root,
        "--checkpoint", f"{cfg.model}_best_model.pth", "--device", dev]))
    path, snapshot = checkpoint_path(icfg, icfg.folds[0])
    save_dir = os.path.join(snapshot, f"{icfg.model}_predictions")
    os.makedirs(save_dir, exist_ok=True)
    volumes = list(trainer.bundle.val_volumes)
    t0 = time.perf_counter()
    model = load_model(icfg, path)
    reset_counts()
    avg, preds = score_volumes(icfg, model, volumes, save_dir)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    depth = sum(-(-v["image"].shape[0] // 8) * 8 for v in volumes)
    expected = {k: v * -(-depth // EVAL_N)
                for k, v in eval_counts(model_name).items()}
    dice = [float(m[:, 0].mean()) for m in evals]
    best = evals[dice.index(max(dice))][:, 0]
    spacing = tuple(float(s) for s in icfg.default_spacing)
    read_back = []
    for vol, pred in zip(volumes, preds):
        img = read_nifti(os.path.join(save_dir, f"{vol['case']}_pred.nii.gz"))
        read_back.append(bool(np.array_equal(img.array_zyx,
                                             pred.astype(np.float32)))
                         and img.spacing == spacing)
    rec = {"checkpoint": os.path.basename(path), "path": path,
           "metrics": avg.tolist(),
           "val_dice": best.tolist(),
           "dice_err": float(np.abs(avg[:, 0] - best).max()),
           "nifti_equal": read_back, "launches": counts,
           "expected": expected, "seconds": seconds}
    expect(rec["dice_err"] <= 1e-6,
           f"inference: per-class Dice {avg[:, 0]} != validation's {best}")
    expect(np.isfinite(avg).all(), f"inference: metrics {avg}")
    expect(all(read_back), f"inference: NIfTI read-back {read_back}")
    expect(counts == expected,
           f"inference: launches {counts} != {expected}")
    return rec


def entry_points(seed, data, scribbles, val, card, dev="cuda", hw=HW,
                 runs=LEARN_RUNS, host_steps=HOST_AUG_STEPS,
                 host_native=HOST_AUG_NATIVE):
    """The phase: each LEARN_RUNS run through the train command line (the
    learning check: its final mean val Dice at least its bound and
    LEARN_RISE over the untrained Dice), the test command on its best
    checkpoint, then fully_supervised with --aug_mode host on slices of a
    native size (no augment launch). With h5py the command reads an H5
    tree of the same data; without it the in-memory bundle."""
    import importlib.util

    from wsl4mis_torch import cli
    from wsl4mis_torch.data import synthetic_slices, zoomed_with_native

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke", "entry")
    have_h5py = importlib.util.find_spec("h5py") is not None
    out = {"card": card, "h5py": have_h5py, "runs": [], "seconds": {}}
    for script, model_name, batch, steps, bound in runs:
        t0 = time.perf_counter()
        train = scribbles if model_name == "unet_cct" else data
        method, defaults = cli.resolve_script(script)
        tree = None
        if have_h5py:
            tree = write_h5_tree(os.path.join(base, f"{method}_data"), data,
                                 scribbles, val, defaults["fold"])
        argv = entry_argv(batch, steps, steps // 2, base, seed, hw) + [
            "--device", dev]
        trainer, rec, evals = run_cli(script, model_name, argv, train, val,
                                      tree, dev)
        rec["inference"] = check_inference(trainer, evals, model_name, dev)
        rec["bound"] = bound
        rec["seconds"] = time.perf_counter() - t0
        out["runs"].append(rec)
        out["seconds"][method] = rec["seconds"]
        expect(rec["val_dice"][-1] >= bound and rec["val_dice"][-1]
               >= rec["dice_before"] + LEARN_RISE,
               f"{script}: val Dice {rec['dice_before']} -> "
               f"{rec['val_dice']}, bound {bound}, rise {LEARN_RISE}")
    t0 = time.perf_counter()
    raw = synthetic_slices(2 * N, host_native, seed=seed + 3)
    tree = None
    if have_h5py:
        tree = write_h5_tree(os.path.join(base, "host_data"), raw, raw, val,
                             "fold5")
    argv = entry_argv(N, host_steps, 10 ** 9, os.path.join(base, "host"),
                      seed, hw) + ["--device", dev, "--aug_mode", "host"]
    _, rec, _ = run_cli("train_fully_supervised_2D", "unet", argv,
                        zoomed_with_native(raw, (hw, hw)), val, tree, dev)
    out["host_aug"] = rec
    out["seconds"]["host_aug"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    line = {"card": card, "h5py": have_h5py, "phase_s": out["phase_s"],
            "seconds": out["seconds"], "runs": [
                {k: r[k] for k in ("method", "batch", "steps", "ms_per_step",
                                   "wall_s", "dice_before", "val_dice",
                                   "bound")}
                | {"inference_dice_err": r["inference"]["dice_err"],
                   "inference_s": r["inference"]["seconds"]}
                for r in out["runs"]],
            "host_aug": {"steps": rec["steps"],
                         "ms_per_step": rec["ms_per_step"],
                         "augment_launches": rec["launches"]["augment"],
                         "losses": rec["losses"]}}
    print("entry-points " + json.dumps(line), flush=True)
    return out


# ---- phase 6: the rest of the model zoo -------------------------------------

ZOO_2D = ("unet", "unet_cct", "unet_cct_3h", "unet_ds", "unet_urds", "pnet",
          "efficient_unet")
ZOO_3D = ("unet_3D", "attention_unet", "vnet", "voxresnet")
ZOO_ITERS = 10  # timed calls of measure_fwd_bwd_time (after 2 warm-up calls)
ZOO_REF_N = 2  # the card-versus-CPU f32 check's batch
# f32 card (TF32 off) against the CPU, relative to the largest magnitude:
# eval logits (each output of a 2D model, a 3D net's) and, for the 3D
# nets, the parameter gradient of sum(out^2) in norm
ZOO_EVAL_TOL = 1e-4
ZOO_GRAD_TOL = 1e-3
ZOO_3D_SHAPE = (2, 96, 96, 96, 1)
ZOO_3D_REF = (1, 32, 32, 32, 1)
ZOO_STEPS = 6
ZOO_TIMED = 5  # steady-state steps of each zoo train run, timed and traced
# (train script, --model, batch, --encoder_weights): fully_supervised and
# pce on the models no earlier phase trains
ZOO_RUNS = (
    ("train_fully_supervised_2D", "pnet", N, False),
    ("train_fully_supervised_2D", "efficient_unet", N, False),
    ("train_fully_supervised_2D", "efficient_unet", N, True),
    ("train_weakly_supervised_pCE_2D", "pnet", MS_N, False),
)


def fwd_bwd_counts(model_name):
    """Launches of one train-mode forward and backward of a UNet-family
    model (a training step's, without the augment)."""
    return dict(per_step_counts(model_name), augment=0)


def _generator(seed):
    import torch

    return torch.Generator().manual_seed(seed)


def zoo_models(seed, dev="cuda", hw=HW, batch=N, widths=None):
    """Each 2D factory model at its published widths (or `widths`' kwargs):
    eval forward and forward + backward timed by the port's
    measure_fwd_bwd_time at (batch, hw, hw, 1) in bf16, with the peak
    memory; the multi-head UNets' launches of one train-mode forward +
    backward against fwd_bwd_counts; the eval logits of the model in f32
    on the card against the same model on the CPU (ZOO_EVAL_TOL)."""
    import copy

    import torch

    from wsl4mis_torch.engine.methods.common import split_rngs
    from wsl4mis_torch.models import MODEL_NUM_OUTPUTS, net_factory
    from wsl4mis_torch.utils.profiling import measure_fwd_bwd_time

    widths = widths or {}
    recs = []
    for i, name in enumerate(ZOO_2D):
        kw = widths.get(name, {})
        model = net_factory(name, 4, dtype=torch.bfloat16,
                            generator=_generator(seed + i), **kw).to(dev)
        x = torch.randn((batch, hw, hw, 1), generator=_generator(seed),
                        ).to(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        fwd_s, fwd_bwd_s = measure_fwd_bwd_time(model, x, n_warmup=2,
                                                n_iters=ZOO_ITERS)
        rec = {"model": name, "batch": batch, "hw": hw,
               "outputs": MODEL_NUM_OUTPUTS[name],
               "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
               "fwd_ms": 1e3 * fwd_s, "fwd_bwd_ms": 1e3 * fwd_bwd_s}
        if dev == "cuda":
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if UNET_HEADS.get(name, 1) > 1 and name != "unet_cct":
            reset_counts()
            out = model(x, train=True, rngs=split_rngs(seed, 0, dev))
            sum((o.float() ** 2).mean() for o in out).backward()
            sync(dev)
            rec["launches"] = launch_counts()
            rec["expected"] = fwd_bwd_counts(name)
            expect(rec["launches"] == rec["expected"],
                   f"zoo {name}: fwd+bwd launches {rec['launches']} != "
                   f"{rec['expected']}")
        del model
        ref = net_factory(name, 4, dtype=torch.float32,
                          generator=_generator(seed + i), **kw).eval()
        card = copy.deepcopy(ref).to(dev)
        xs = torch.randn((ZOO_REF_N, hw, hw, 1), generator=_generator(
            seed + 1))
        with torch.no_grad():
            want = ref(xs, train=False)
            got = card(xs.to(dev), train=False)
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        rec["ref_err"] = max(rel_max(g.cpu(), w) for g, w in zip(got, want))
        expect(len(got) == MODEL_NUM_OUTPUTS[name] and all(
            g.shape == (ZOO_REF_N, hw, hw, 4) for g in got),
            f"zoo {name}: outputs {[tuple(g.shape) for g in got]}")
        expect(rec["ref_err"] <= ZOO_EVAL_TOL,
               f"zoo {name}: card against CPU {rec['ref_err']}")
        recs.append(rec)
        del ref, card
    return recs


def check_3d(label, build, seed, dev="cuda", shape=ZOO_3D_SHAPE,
             ref_shape=ZOO_3D_REF, spread_threads=()):
    """A 3D net (build(dtype) -> the model on the CPU, the same draws for
    either dtype): forward and forward + backward timed at `shape` in bf16
    with the peak memory; in f32 at `ref_shape`, its eval logits and the
    gradient of sum(out^2) on the card against the CPU (ZOO_EVAL_TOL,
    ZOO_GRAD_TOL). With spread_threads, the CPU's own gradient spread (its
    gradient at each of those intra-op thread counts against the default
    count's) is measured, and the gradient is held to the larger of
    ZOO_GRAD_TOL and twice it."""
    import copy

    import torch

    from wsl4mis_torch.utils.profiling import measure_fwd_bwd_time

    model = build(torch.bfloat16).to(dev)
    x = torch.randn(shape, generator=_generator(seed)).to(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fwd_s, fwd_bwd_s = measure_fwd_bwd_time(model, x, n_warmup=1, n_iters=3)
    rec = {"model": label, "shape": list(shape),
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
           "fwd_ms": 1e3 * fwd_s, "fwd_bwd_ms": 1e3 * fwd_bwd_s}
    if dev == "cuda":
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    ref = build(torch.float32).eval()
    card = copy.deepcopy(ref).to(dev)
    xs = torch.randn(ref_shape, generator=_generator(seed + 1))
    outs, grads = [], []
    for m, xx in ((ref, xs), (card, xs.to(dev))):
        out = m(xx, train=False)
        outs.append(out.detach().cpu())
        grads.append(torch.cat([g.flatten().cpu() for g in
                                torch.autograd.grad(
                                    (out ** 2).sum(), m.parameters())]))
    rec["ref_err"] = rel_max(outs[1], outs[0])
    rec["grad_err"] = rel_norm(grads[1], grads[0])
    rec["grad_tol"] = ZOO_GRAD_TOL
    if spread_threads:
        threads = torch.get_num_threads()
        spread = []
        try:
            for n in spread_threads:
                torch.set_num_threads(n)
                out = ref(xs, train=False)
                g = torch.cat([g.flatten() for g in torch.autograd.grad(
                    (out ** 2).sum(), ref.parameters())])
                spread.append(rel_norm(g, grads[0]))
        finally:
            torch.set_num_threads(threads)
        rec["cpu_spread"] = max(spread)
        rec["grad_tol"] = max(ZOO_GRAD_TOL, 2 * rec["cpu_spread"])
    expect(outs[1].shape == ref_shape[:4] + (2,),
           f"{label}: output {tuple(outs[1].shape)}")
    expect(rec["ref_err"] <= ZOO_EVAL_TOL
           and rec["grad_err"] <= rec["grad_tol"],
           f"{label}: card against CPU {rec['ref_err']}, gradient "
           f"{rec['grad_err']} (limit {rec['grad_tol']})")
    return rec


def zoo_3d(seed, dev="cuda", shape=ZOO_3D_SHAPE, ref_shape=ZOO_3D_REF,
           widths=None):
    """Each net_factory_3d model (1 channel, 2 classes, published
    filters, or `widths`' kwargs) through check_3d."""
    from wsl4mis_torch.models import net_factory_3d

    widths = widths or {}
    return [check_3d(name, lambda dtype, i=i, name=name: net_factory_3d(
        name, 2, dtype=dtype, generator=_generator(seed + i),
        **widths.get(name, {})), seed, dev, shape, ref_shape)
        for i, name in enumerate(ZOO_3D)]


def synth_efficientnet(model_name, seed):
    """A synthesized efficientnet_pytorch state_dict of `model_name` (its
    key names and shapes, N(0, 0.05) weights, unit running variances): no
    ImageNet file exists offline."""
    import numpy as np
    import torch

    from wsl4mis_torch.models.efficientunet import (
        BASE_BLOCKS,
        SCALING,
        round_filters,
        round_repeats,
    )

    rs = np.random.RandomState(seed)
    width, depth, _ = SCALING[model_name]
    sd = {}

    def randn(*shape):
        return torch.from_numpy((0.05 * rs.randn(*shape)).astype(np.float32))

    def bn(prefix, ch):
        sd[f"{prefix}.weight"] = 1.0 + randn(ch)
        sd[f"{prefix}.bias"] = randn(ch)
        sd[f"{prefix}.running_mean"] = randn(ch)
        sd[f"{prefix}.running_var"] = torch.ones(ch)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    stem = round_filters(32, width)
    sd["_conv_stem.weight"] = randn(stem, 3, 3, 3)
    bn("_bn0", stem)
    bi = 0
    for e, k, _s, fin, fout, r in BASE_BLOCKS:
        out_f = round_filters(fout, width)
        for j in range(round_repeats(r, depth)):
            pre = f"_blocks.{bi}"
            cin = round_filters(fin, width) if j == 0 else out_f
            ch = cin * e
            if e != 1:
                sd[f"{pre}._expand_conv.weight"] = randn(ch, cin, 1, 1)
                bn(f"{pre}._bn0", ch)
            sd[f"{pre}._depthwise_conv.weight"] = randn(ch, 1, k, k)
            bn(f"{pre}._bn1", ch)
            se = max(1, int(cin * 0.25))
            sd[f"{pre}._se_reduce.weight"] = randn(se, ch, 1, 1)
            sd[f"{pre}._se_reduce.bias"] = randn(se)
            sd[f"{pre}._se_expand.weight"] = randn(ch, se, 1, 1)
            sd[f"{pre}._se_expand.bias"] = randn(ch)
            sd[f"{pre}._project_conv.weight"] = randn(out_f, ch, 1, 1)
            bn(f"{pre}._bn2", out_f)
            bi += 1
    return sd


def zoo_train(seed, data, scribbles, val, base, dev="cuda", hw=HW,
              runs=ZOO_RUNS, steps=ZOO_STEPS, encoder="efficientnet-b3"):
    """The train command on the zoo's single-output models (run_cli: the
    launches, one augment a step and nothing else, finite losses, the
    checkpoints), ms/step and peak GB, and on the card ZOO_TIMED more
    steps timed and traced (time_step); --encoder_weights reads a file the
    convert_torch_weights command wrote from a synthesized state_dict,
    and the run's config must build its model from it."""
    import numpy as np
    import torch

    from wsl4mis_torch import cli
    from wsl4mis_torch.engine.methods.common import (
        make_model_and_state,
        train_batches,
    )
    from wsl4mis_torch.utils.checkpoint import load_jax_checkpoint

    os.makedirs(base, exist_ok=True)
    pth = os.path.join(base, "efficientnet.pth")
    torch.save(synth_efficientnet(encoder, seed), pth)
    enc_file = os.path.join(base, "efficientnet_1ch.msgpack")
    cli.main(["convert_torch_weights", "--torch_ckpt", pth, "--model_name",
              encoder, "--out", enc_file])
    stem = load_jax_checkpoint(enc_file)["encoder_params"]["Conv_0"][
        "kernel"]
    recs = []
    for i, (script, model_name, batch, weights) in enumerate(runs):
        argv = entry_argv(batch, steps, 10 ** 9,
                          os.path.join(base, f"run{i}"), seed, hw) + [
            "--device", dev, "--model", model_name]
        if weights:
            argv += ["--encoder_weights", enc_file]
        method, defaults = cli.resolve_script(script)
        train = data if method == "fully_supervised" else scribbles
        if weights:  # the run's config builds its model from the file
            cfg = cli.config_from_args(
                cli.build_parser(defaults).parse_args(argv), method)
            model, _ = make_model_and_state(cfg)
            expect(np.array_equal(model.state_dict()[
                "efficient_net_encoder.0.conv.0.kernel"].cpu().numpy(),
                stem), "zoo: --encoder_weights: the stem is not the file's")
            del model
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        trainer, rec, _ = run_cli(script, model_name, argv, train, val,
                                  None, dev)
        rec["model"] = model_name
        rec["encoder_weights"] = weights
        if dev == "cuda":
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        expect(rec["launches"]["augment"] == steps,
               f"zoo {model_name}: {rec['launches']['augment']} augment "
               f"launches in {steps} steps")
        if dev == "cuda":
            it = train_batches(trainer.cfg, train)
            t = time_step(trainer.bundle.step_fn, trainer.bundle.state,
                          trainer.bundle.aux, trainer.cfg,
                          [next(it) for _ in range(ZOO_TIMED)], seed)
            prof = t.pop("profile")
            rec["timed"] = t | {k: prof[k] for k in (
                "device_busy_ms_per_step", "device_busy_share",
                "ms_per_step_by_class")}
        recs.append(rec)
        del trainer
    return recs


def _zoo_weights(name, unet_sd):
    """A trained UNet's weights carried into a UNet_DS (its full-scale
    head the UNet's head) or a UNet_CCT_3H (its main decoder the UNet's
    decoder); the other heads and decoders keep their init."""
    out = {}
    for k, v in unet_sd.items():
        if name == "unet_ds":
            k = k.replace("decoder.head.", "decoder.heads.3.")
        elif k.startswith("decoder."):
            k = "main_" + k
        out[k] = v
    return out


def zoo_inference(unet_path, val, base, dev="cuda", widths=None):
    """The test command (--model unet_ds / unet_cct_3h) on a checkpoint
    this phase saves: a model carrying the entry phase's trained UNet
    (_zoo_weights), validated as a Trainer at the reference's 256x256
    validates (evaluate_fold of the VolumePredictor; the test command
    predicts at 256x256), saved as the Trainer saves; the command's
    per-class Dice must equal that validation's (difference 0.0) and its
    launches be one eval forward a chunk."""
    import numpy as np
    import torch

    from wsl4mis_torch import cli
    from wsl4mis_torch.eval.infer import (
        checkpoint_path,
        load_model,
        score_volumes,
    )
    from wsl4mis_torch.eval.val2d import VolumePredictor, evaluate_fold
    from wsl4mis_torch.models import net_factory
    from wsl4mis_torch.utils.checkpoint import save_model_checkpoint

    widths = widths or {}
    unet_sd = torch.load(unet_path, map_location="cpu",
                         weights_only=True)["model"]
    volumes = list(val)
    recs = []
    for name in ("unet_ds", "unet_cct_3h"):
        model = net_factory(name, 4, dtype=torch.bfloat16,
                            generator=_generator(0), **widths.get(name, {}))
        own = model.state_dict()
        own.update(_zoo_weights(name, unet_sd))
        model.load_state_dict(own, strict=True)
        model = model.to(dev)
        val_metrics = evaluate_fold(VolumePredictor(model, (HW, HW),
                                                    device=dev), volumes, 4)
        snap = os.path.join(base, "test", f"ACDC_{name}_fold1", "label")
        save_model_checkpoint(os.path.join(snap, f"{name}_best_model.pth"),
                              _as_state(model))
        icfg = cli.inference_config(cli.test_parser().parse_args([
            "--exp", f"ACDC_{name}", "--model", name, "--fold", "fold1",
            "--sup_type", "label", "--snapshot_root",
            os.path.join(base, "test"), "--checkpoint",
            f"{name}_best_model.pth", "--device", dev]))
        path, _ = checkpoint_path(icfg, icfg.folds[0])
        loaded = load_model(icfg, path)
        reset_counts()
        avg, _ = score_volumes(icfg, loaded, volumes)
        sync(dev)
        counts = {k: v for k, v in launch_counts().items() if v}
        depth = sum(-(-v["image"].shape[0] // 8) * 8 for v in volumes)
        expected = {k: v * -(-depth // EVAL_N)
                    for k, v in eval_counts(name).items()}
        rec = {"model": name, "metrics": avg.tolist(),
               "val_dice": val_metrics[:, 0].tolist(),
               "dice_err": float(np.abs(avg[:, 0] - val_metrics[:, 0]).max()),
               "launches": counts, "expected": expected}
        expect(rec["dice_err"] == 0.0,
               f"zoo test --model {name}: Dice {avg[:, 0]} != validation's "
               f"{val_metrics[:, 0]}")
        expect(np.isfinite(avg).all(), f"zoo test {name}: metrics {avg}")
        expect(counts == expected,
               f"zoo test {name}: launches {counts} != {expected}")
        recs.append(rec)
    return recs


def _as_state(model):
    """The model as the checkpoint writer reads a train state."""
    import types

    return types.SimpleNamespace(model=model, step=0, extra=None)


def zoo_svc_test(svc_run, val, dev="cuda"):
    """test_scribblevc ACDC's scoring (its parser's flags, load_scribblevc,
    score_scribblevc) on the ScribbleVC run's last checkpoint, over the
    volumes that run validated: per-class Dice equal to the select rule's
    validation (difference 0.0); a phantom volume holds every class, so
    the validation's NaN-aware Dice is the plain one. A 10-step run
    predicts background everywhere, so the check repeats on a checkpoint
    whose decisions are not (_svc_shifted), validated here as the
    Trainer validates and scored by the command's path: Dice equal, and
    above 0 for some class."""
    import numpy as np

    from wsl4mis_torch import cli
    from wsl4mis_torch.engine.methods.scribblevc import mean_softmax_decision
    from wsl4mis_torch.eval.infer import load_scribblevc, score_scribblevc
    from wsl4mis_torch.eval.val2d import VolumePredictor, evaluate_fold
    from wsl4mis_torch.utils.checkpoint import save_model_checkpoint

    snap = svc_run["snapshot"]
    args = cli.scribblevc_test_parser("ACDC").parse_args([
        "--snapshot_root", snap["snapshot_root"], "--exp", snap["exp"],
        "--fold", snap["fold"], "--sup_type", snap["sup_type"],
        "--checkpoint", f"iter_{svc_run['steps']}.pth", "--device", dev])
    path, = cli.scribblevc_checkpoints(args)
    model, memory = load_scribblevc(path, args.num_classes,
                                    args.compute_dtype, args.device)
    avg = score_scribblevc(cli.scribblevc_inference_config(args), model,
                           memory, list(val))
    want = np.asarray(svc_run["select_val"])[:, 0]
    rec = {"checkpoint": os.path.basename(path), "metrics": avg.tolist(),
           "val_dice": want.tolist(),
           "dice_err": float(np.abs(avg[:, 0] - want).max())}
    expect(rec["dice_err"] == 0.0,
           f"test_scribblevc: Dice {avg[:, 0]} != select validation's "
           f"{want}")

    _svc_shifted(model, memory, val, dev)
    select = VolumePredictor(model, (HW, HW), device=dev,
                             decision_fn=mean_softmax_decision,
                             forward_kwargs={"use_class_rep": False})
    val_metrics = evaluate_fold(select, list(val), args.num_classes,
                                nan_aware=True, variables={"memory": memory})
    shifted = os.path.join(os.path.dirname(path), "zoo_shifted.pth")
    state = _as_state(model)
    state.extra = {"class_memory": memory}
    save_model_checkpoint(shifted, state, eval_extra=("class_memory",))
    model, memory = load_scribblevc(shifted, args.num_classes,
                                    args.compute_dtype, args.device)
    avg = score_scribblevc(cli.scribblevc_inference_config(args), model,
                           memory, list(val))
    rec["shifted"] = {"metrics": avg.tolist(),
                      "val_dice": val_metrics[:, 0].tolist(),
                      "dice_err": float(np.abs(avg[:, 0]
                                               - val_metrics[:, 0]).max())}
    expect(rec["shifted"]["dice_err"] == 0.0 and avg[:, 0].max() > 0,
           f"test_scribblevc, shifted heads: Dice {avg[:, 0]} against "
           f"the validation's {val_metrics[:, 0]}")
    return rec


def _svc_shifted(model, memory, val, dev):
    """Make a ScribbleVC's mean-softmax decision mix the classes, in place:
    the conv decoder's head zeroed (its softmax uniform, so the decision
    is the transformer head's argmax), and the transformer head's class
    biases moved by the median over `val`'s pixels of each class's logit
    margin over background."""
    import torch

    from wsl4mis_torch.engine.methods.scribblevc import mean_softmax_decision
    from wsl4mis_torch.eval.val2d import VolumePredictor

    outs = []

    def grab(out):
        outs.append(out[1])
        return mean_softmax_decision(out)

    with torch.no_grad():
        model.seg_head.kernel.zero_()
        model.seg_head.bias.zero_()
        VolumePredictor(model, (HW, HW), device=dev, decision_fn=grab,
                        forward_kwargs={"use_class_rep": False}
                        ).predict_volumes([v["image"] for v in val],
                                          {"memory": memory})
        logits = torch.cat(outs).flatten(0, 2)
        margin = (logits - logits[:, :1]).median(0).values
        model.trans_head.bias -= margin.to(model.trans_head.bias.dtype)


def zoo_phase(seed, data, scribbles, val, card, unet_path, svc_run,
              dev="cuda", hw=HW, batch=N, widths=None, shape3d=ZOO_3D_SHAPE,
              ref3d=ZOO_3D_REF, runs=ZOO_RUNS, steps=ZOO_STEPS):
    """Phase 6 (after the entry points: the train command sets cuDNN
    deterministic, so the phase first puts cuDNN back to its defaults for
    its timings): zoo_models, zoo_3d, zoo_train, zoo_inference and
    zoo_svc_test; prints the zoo line."""
    import torch

    widths = widths or {}
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    base = os.path.join(ROOT, "build", "chip_smoke", "zoo")
    out = {"card": card, "models": zoo_models(seed, dev, hw, batch, widths)}
    out["nets3d"] = zoo_3d(seed, dev, shape3d, ref3d, widths)
    out["train"] = zoo_train(seed, data, scribbles, val, base, dev, hw, runs,
                             steps, encoder=widths.get("efficient_unet", {}).get(
                                 "encoder_name", "efficientnet-b3"))
    out["inference"] = zoo_inference(unet_path, val, base, dev, widths)
    out["svc_test"] = zoo_svc_test(svc_run, val, dev)
    out["phase_s"] = time.perf_counter() - t0
    keep = ("model", "batch", "fwd_ms", "fwd_bwd_ms", "peak_gb", "ref_err",
            "grad_err", "launches", "expected")
    line = {"card": card, "phase_s": out["phase_s"],
            "models": [{k: r[k] for k in keep if k in r}
                       for r in out["models"]],
            "nets3d": [{k: r[k] for k in keep if k in r}
                       for r in out["nets3d"]],
            "train": [{k: r[k] for k in ("model", "method", "batch", "steps",
                                         "encoder_weights", "ms_per_step",
                                         "peak_gb", "losses", "timed")
                       if k in r} for r in out["train"]],
            "test_dice_err": {r["model"]: r["dice_err"]
                              for r in out["inference"]},
            "test_scribblevc_dice_err": out["svc_test"]["dice_err"],
            "test_scribblevc_shifted": out["svc_test"]["shifted"]}
    print("zoo " + json.dumps(line), flush=True)
    return out


# ---- phase 7: resuming a JAX run's checkpoint -------------------------------

RESUME_BEFORE = 2  # steps before the checkpoint (scribblevc: to its gate)
RESUME_AFTER = 2  # steps from the written and from the restored state
RESUME_S2L_SLICES = 1100  # s2l's (N, 256, 256, 4) f32 buffer over 1 GiB
RESUME_CLI = (3, 4)  # the train command's run: checkpoint at N, then k steps


def resume_runs():
    """(method, model, batch, data kind) of the phase: one method per
    layout of the JAX package's latest_full.ckpt, at its cell's batch."""
    return (("fully_supervised", "unet", N, "dense"),
            ("uamt", "unet", SEMI_N, "semi"),
            ("deep_adversarial", "unet", SEMI_N, "semi"),
            ("s2l", "unet", SEMI_N, "s2l"),
            ("scribblevc", "scribblevc", SVC_N, "svc"))


def state_leaves(state):
    """Every leaf of a train state by path (TrainState.state_dict: step,
    model, optimizer, extra)."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = x
    walk("", state.state_dict())
    return out


def leaves_diff(a, b):
    """(paths whose leaves differ bit for bit, the largest absolute
    difference over the tensors)."""
    import torch

    if a.keys() != b.keys():
        return sorted(a.keys() ^ b.keys()), math.inf
    bad, worst = [], 0.0
    for k, u in a.items():
        v = b[k]
        if isinstance(u, torch.Tensor):
            if not torch.equal(u, v):
                bad.append(k)
                worst = max(worst, float((u.double() - v.double()).abs()
                                         .max()))
        elif u != v:
            bad.append(k)
            worst = math.inf
    return bad, worst


def _snapshot(leaves):
    import torch

    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in leaves.items()}


def host_peak_gb():
    """The process's peak resident memory so far (ru_maxrss), GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def resume_run(method, model_name, batch, data, val, seed, dev="cuda",
               hw=HW, dtype="bfloat16"):
    """One layout: RESUME_BEFORE steps (scribblevc: to the step after its
    memory gate opens; s2l: a refresh sweep after them, period_iter 2),
    save_jax_train_state, a fresh bundle (another seed) restored through
    restore_train_state, which must take the JAX format, every leaf
    bit-equal; then RESUME_AFTER steps from each state on the same batches
    and (seed, step) draws (s2l: the refresh after the second): equal bit
    for bit (under the phase's deterministic algorithms). Launches of each
    run of steps must be their per-step counts. Then, with PyTorch's
    deterministic algorithms off, the same steps twice from the file must
    repeat bit for bit too (default_mode_repeat)."""
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.methods.common import split_rngs
    from wsl4mis_torch.utils import checkpoint as ck

    flags = {}
    before = RESUME_BEFORE
    if method == "s2l":
        flags = dict(period_iter=RESUME_BEFORE, thr_iter=RESUME_BEFORE,
                     thr_conf=0.04)
    if method == "scribblevc":
        before = svc_gate_step(len(data), batch) + 1
    snap = os.path.join(ROOT, "build", "chip_smoke", "resume", method)
    cfg = TrainConfig(
        method=method, model=model_name, batch_size=batch,
        labeled_bs=batch // 2, max_iterations=100, compute_dtype=dtype,
        snapshot_root=snap, seed=seed, device=dev, patch_size=(hw, hw),
        sup_type=sup_type_of(method), **flags)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bundle, new_batches = method_bundle(cfg, data, val)
    it = new_batches()
    batches = [next(it) for _ in range(before + RESUME_AFTER)]
    n_slices = bundle.aux["images"].shape[0]
    per_step = per_step_counts(model_name, method)

    def expected(steps, refreshes):
        out = {k: v * steps for k, v in per_step.items()}
        for k, v in refresh_counts(model_name, n_slices).items():
            out[k] += v * refreshes
        return out

    def take(b, ts):
        """Steps ts of bundle b as the Trainer runs them (its host hook
        after each); their losses, wall seconds and launches."""
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        losses = []
        for t in ts:
            rngs = split_rngs(cfg.seed, b.state.step, dev)
            losses.append(b.step_fn(b.state, batches[t], rngs, b.aux)[
                "total_loss"])
            if b.host_hook is not None:
                b.host_hook(b, b.state, b.state.step)
        sync(dev)
        wall = time.perf_counter() - t0
        return [float(v) for v in losses], wall, launch_counts()

    def refreshes(ts):
        """s2l's host hook refreshes after every RESUME_BEFORE-th step."""
        if method != "s2l":
            return 0
        return sum((t + 1) % RESUME_BEFORE == 0 for t in ts)

    rec = {"method": method, "model": model_name, "batch": batch,
           "slices": n_slices, "steps_before": before}
    losses, _, counts = take(bundle, range(before))
    expect(counts == expected(before, refreshes(range(before))),
           f"resume {method}: launches before the checkpoint {counts}")
    path = os.path.join(cfg.snapshot_path, "latest_full.ckpt")
    chunked = []
    chunk_fn = ck._chunked

    def counted_chunks(x):
        out = chunk_fn(x)
        chunked.append(len(out["chunks"]))
        return out

    ck._chunked = counted_chunks
    try:
        sync(dev)
        t0 = time.perf_counter()
        ck.save_jax_train_state(path, bundle.state)
        rec["save_s"] = time.perf_counter() - t0
    finally:
        ck._chunked = chunk_fn
    rec["file_mb"] = os.path.getsize(path) / 2 ** 20
    rec["chunked_leaves"] = chunked
    saved = _snapshot(state_leaves(bundle.state))
    fresh, _ = method_bundle(cfg.replace(seed=seed + 1), data, val)
    t0 = time.perf_counter()
    fmt = ck.restore_train_state(path, fresh.state)
    sync(dev)
    rec["restore_s"] = time.perf_counter() - t0
    rec["format"] = fmt
    bad, _ = leaves_diff(state_leaves(fresh.state), saved)
    rec["restored_leaves"] = len(saved)
    rec["restore_diff"] = bad
    expect(fmt == "jax" and not bad,
           f"resume {method}: format {fmt}, leaves not restored: {bad[:5]}")
    after = range(before, before + RESUME_AFTER)
    la, wall_a, counts_a = take(bundle, after)
    lb, wall_b, counts_b = take(fresh, after)
    rec.update(losses_before=losses, losses_after=la, losses_resumed=lb,
               ms_per_step=1e3 * wall_b / RESUME_AFTER,
               launches=counts_b)
    want = expected(RESUME_AFTER, refreshes(after))
    expect(counts_a == want and counts_b == want,
           f"resume {method}: launches {counts_a} / {counts_b} != {want}")
    bad, diff = leaves_diff(state_leaves(bundle.state),
                            state_leaves(fresh.state))
    rec["after_diff"] = {"leaves": len(bad), "max_abs": diff}
    expect(not bad, f"resume {method}: resumed steps differ from the "
                    f"uninterrupted ones in {len(bad)} leaves, by {diff}")
    # without PyTorch's deterministic algorithms: the same steps twice from
    # the file
    torch.use_deterministic_algorithms(False)
    try:
        runs = []
        for _ in range(2):
            ck.restore_train_state(path, fresh.state)
            take(fresh, after)
            runs.append(_snapshot(state_leaves(fresh.state)))
    finally:
        torch.use_deterministic_algorithms(True, warn_only=True)
    bad, diff = leaves_diff(*runs)
    rec["default_mode_repeat"] = {"leaves": len(bad), "max_abs": diff}
    expect(not bad, f"resume {method}: two default-mode runs of the same "
                    f"steps differ in {len(bad)} leaves, by {diff}")
    if dev == "cuda":
        rec["device_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["host_peak_gb"] = host_peak_gb()
    expect(all(math.isfinite(v) for v in la + lb),
           f"resume {method}: losses {la} {lb}")
    del bundle, fresh
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return rec


def resume_cli(seed, data, val, dev="cuda", hw=HW, steps=RESUME_CLI):
    """The train command (fully_supervised, batch N) runs n steps and its
    latest_full.ckpt is rewritten in the JAX layout; the command again
    with --resume and --max_iterations n + k restores it (the JAX format,
    at step n, every leaf bit-equal), takes exactly k steps and writes its
    checkpoints."""
    from wsl4mis_torch.utils import checkpoint as ck

    n, k = steps
    base = os.path.join(ROOT, "build", "chip_smoke", "resume", "cli")
    shutil.rmtree(base, ignore_errors=True)
    script = "train_fully_supervised_2D"
    first = cli_trainer(script, entry_argv(N, n, 10 ** 9, base, seed, hw)
                        + ["--device", dev], data, val)
    first.train()
    ckpt = os.path.join(first.cfg.snapshot_path, "latest_full.ckpt")
    ck.save_jax_train_state(ckpt, first.state)
    saved = _snapshot(state_leaves(first.state))
    argv = entry_argv(N, n + k, 10 ** 9, base, seed, hw) + [
        "--device", dev, "--resume"]
    trainer = cli_trainer(script, argv, data, val)
    bad, _ = leaves_diff(state_leaves(trainer.state), saved)
    taken = []
    step_fn = trainer.bundle.step_fn

    def counted(state, batch, rngs, aux=None):
        taken.append(state.step)
        return step_fn(state, batch, rngs, aux)

    trainer.bundle.step_fn = counted
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    trainer.train()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    snap = trainer.cfg.snapshot_path
    with open(os.path.join(snap, "log.txt")) as f:
        logged = f"{ckpt} (jax format) at step {n}" in f.read()
    files = {name: os.path.isfile(os.path.join(snap, name))
             for name in (f"iter_{n + k}.pth", "latest_full.ckpt")}
    rec = {"method": "fully_supervised", "batch": N, "resumed_at": n,
           "steps": taken, "logged": logged, "restore_diff": bad,
           "files": files, "torch_format_after": ck._is_torch_file(ckpt),
           "launches": counts, "wall_s": wall}
    print(f"resume-cli: resumed at step {n} (jax format), took steps "
          f"{taken}", flush=True)
    expect(not bad and logged, f"resume-cli: restore {bad}, logged "
                               f"{logged}")
    expect(taken == list(range(n, n + k)) and trainer.state.step == n + k,
           f"resume-cli: steps {taken}")
    expect(all(files.values()) and rec["torch_format_after"],
           f"resume-cli: checkpoints {files}")
    want = {key: v * k for key, v in per_step_counts(
        "unet", "fully_supervised").items()}
    expect(counts == want, f"resume-cli: launches {counts} != {want}")
    return rec


def resume_phase(seed, data, scribbles, val, labeled, unlabeled, svc_data,
                 card, dev="cuda", hw=HW, s2l_slices=RESUME_S2L_SLICES,
                 dtype="bfloat16"):
    """Phase 7: resume_run for each layout (s2l on s2l_slices scribble
    phantoms, so that its buffer is written as flax's chunks), under the
    train command's cuDNN setting (--deterministic 1) and PyTorch's
    deterministic algorithms (an op without a deterministic implementation
    would warn, and the warnings are recorded); then resume_cli. Prints the
    resume line."""
    import warnings

    import torch

    from wsl4mis_torch import cli
    from wsl4mis_torch.data import synthetic_slices

    t0 = time.perf_counter()
    cli.set_deterministic(1)
    inputs = {"dense": data, "semi": (labeled, unlabeled), "svc": svc_data,
              "s2l": synthetic_slices(s2l_slices, (hw, hw), seed=seed + 4,
                                      sup_type="scribble")}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [resume_run(method, model, batch, inputs[kind], val, seed,
                               dev, hw, dtype)
                    for method, model, batch, kind in resume_runs()]
            resumed = resume_cli(seed, data, val, dev, hw)
    finally:
        torch.use_deterministic_algorithms(False)
    out = {"card": card, "runs": runs, "cli": resumed,
           "warnings": sorted({str(w.message)[:300] for w in caught
                               if "deterministic" in str(w.message)}),
           "phase_s": time.perf_counter() - t0}
    keep = ("method", "batch", "slices", "steps_before", "file_mb",
            "chunked_leaves", "save_s", "restore_s", "restored_leaves",
            "after_diff", "default_mode_repeat", "ms_per_step",
            "device_peak_gb", "host_peak_gb")
    line = {"card": card, "phase_s": out["phase_s"],
            "runs": [{k: r[k] for k in keep if k in r} for r in runs],
            "cli": {k: out["cli"][k] for k in ("resumed_at", "steps",
                                               "wall_s")},
            "warnings": out["warnings"]}
    print("resume " + json.dumps(line), flush=True)
    return out


# ---- phase 8: data parallel -------------------------------------------------


# (method, model, batch, data kind) of the two-rank cells
DP_CELLS = (("fully_supervised", "unet", N, "dense"),
            ("dmpls", "unet_cct", DMPLS_N, "scribble"),
            ("uamt", "unet", SEMI_N, "semi"),
            ("s2l", "unet", SEMI_N, "s2l"),
            ("scribblevc", "scribblevc", SVC_N, "svc"))
DP_STEPS = 2
DP_SLICES = 48  # phantoms a cell (semi: half labeled); scribblevc: SVC_SLICES
DP_NCCL_STEPS = 10  # steps of the world-size-1 NCCL run and of its twin
DP_MAX_CARDS = 4
# tests/test_sharding.py's tolerances: parameters (and the method's extra
# state) to 1e-4 under SGD; under Adam to about 2.2 lr an update, since
# Adam turns a reassociation-flipped sign of a near-zero gradient into a
# full +-lr step (its 1.2e-3 and 3e-4 are for one step; a conv bias
# before BN, whose gradient is rounding noise, moved 1.4e-3 in two
# ScribbleVC steps on the CPU); the loss relative; the class memory loose
# (its batch contraction's intermediates reach ~1e4) under a gate-flip
# ceiling; its gate decisions exact. BN running statistics relative to
# the layer's second moment (var + mean^2, the scale at which the
# one-pass variance rounds). Adam's parameters cannot tell a wrong
# gradient (two gradients put them at most 2 lr apart), so the first
# moments, linear in the gradient, are held in norm (dp_moments): the
# step's change of the moment within DP_MOMENT_RTOL of the single
# process's change. Measured on the CPU at 64x64 (narrow models, batch
# 8): sound runs at W = 2 and 4 <= 1.4e-6 for the UNet methods (pce_tv
# 2.7e-4, its |.|'s kink) and DAN's discriminator, <= 1.6e-2 for
# ScribbleVC, whose first step from its initial state is that sensitive
# in one process too (1 against 3 CPU threads: 8.9e-3); planted faults:
# every gradient summed, not averaged, 1.0 (W = 2); ScribbleVC's memory
# sums without their all-reduce backward 6.2e-2 (W = 2), 9.3e-2 (W = 4),
# with its parameters exactly as close as in the sound run. On an NVIDIA
# H100 80GB HBM3 (700 W), phase 8's cells at full width: sound 2.5e-5 to
# 2.1e-4, ScribbleVC 1.3e-2; summed 1.1 and 1.0; the memory fault 7.1e-2
# and 1.5e-1 (steps 0, 1).
DP_SGD_ATOL = 1e-4
DP_ADAM_ATOL = {"scribblevc": 1.2e-3, "deep_adversarial": 3e-4}  # a step
DP_LOSS_RTOL = 1e-4
DP_MEMORY_ATOL, DP_GATE_FLIP = 5e-2, 0.5
DP_STATE_RTOL = 1e-4
DP_MOMENT_RTOL = {None: 1e-2, "scribblevc": 3e-2}
DP_EXACT_METRICS = ("proto_acc_conv", "proto_acc_tran")


def cell_opts(cell):
    """A data-parallel cell's own options, its fifth entry where it has
    one: "flags" (more TrainConfig fields; device_data False: the batches
    stay on the host, each rank keeps its rows there and dp_steps copies
    them, as the Trainer does) and "steps" (else DP_STEPS). They are the
    only way to give a cell flags or steps of its own."""
    return cell[4] if len(cell) > 4 else {}


def cell_steps(cell):
    return cell_opts(cell).get("steps", DP_STEPS)


def cell_key(cell):
    """A cell's name in a group's records: its method, and its flags."""
    flags = cell_opts(cell).get("flags", {})
    return cell[0] + "".join(f"/{k}={v}" for k, v in sorted(flags.items()))


def dp_cell(method, batch):
    """(method, model, batch, data kind) of a method's cell."""
    model = {"dmpls": "unet_cct", "scribblevc": "scribblevc"}.get(method,
                                                                 "unet")
    if method in SEMI:
        kind = "semi"
    elif method in ("s2l", "scribblevc"):
        kind = {"s2l": "s2l", "scribblevc": "svc"}[method]
    else:
        kind = "scribble" if sup_type_of(method) == "scribble" else "dense"
    return method, model, batch, kind


def dp_data(kind, hw, seed):
    """A cell's phantoms, made from the seed (the same in every process)."""
    from wsl4mis_torch.data import ArraySliceDataset, synthetic_slices

    if kind == "svc":
        return synthetic_slices(SVC_SLICES, (hw, hw), seed=seed + 2,
                                sup_type="scribble")
    sup = "label" if kind in ("dense", "semi") else "scribble"
    data = synthetic_slices(DP_SLICES, (hw, hw), seed=seed, sup_type=sup)
    if kind != "semi":
        return data
    half = DP_SLICES // 2
    return (ArraySliceDataset(data.images[:half], data.labels[:half]),
            ArraySliceDataset(data.images[half:], data.labels[half:]))


def dp_bundle(cell, spec):
    """(cfg, bundle, the global batches) of one cell: its method's bundle
    (method_bundle) from spec's seed, at spec's size and dtype; scribblevc
    with its memory gate open from the first step, s2l with its
    pseudo-label term open on its zero buffer (as tests/test_sharding.py
    runs it: pseudo labels thresholded off a refreshed buffer flip with its
    rounding) and a refresh sweep after the last step; the cell's own
    flags and steps (cell_opts)."""
    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.methods.common import DeviceBatches

    method, model_name, batch, kind = cell[:4]
    hw, seed = spec["hw"], spec["seed"]
    flags = dict(cell_opts(cell).get("flags", {}))
    steps = cell_steps(cell)
    if method == "s2l":
        flags.update(period_iter=steps, thr_iter=0)
    cfg = TrainConfig(
        method=method, model=model_name, batch_size=batch,
        labeled_bs=batch // 2, max_iterations=100,
        compute_dtype=spec["dtype"], seed=seed, device=spec["device"],
        patch_size=(hw, hw), sup_type=sup_type_of(method), **flags)
    data = dp_data(kind, hw, seed)
    bundle, new_batches = method_bundle(cfg, data, None)
    if method == "scribblevc":
        bundle.state.step = svc_gate_step(len(data), batch)
    it = new_batches()
    if isinstance(it, DeviceBatches):
        it = it.host
    return cfg, bundle, [next(it) for _ in range(steps)]


def dp_steps(cfg, bundle, batches, dev, before=None, after=None):
    """The steps as the Trainer takes them (this rank's rows of each batch,
    the host hook after each): losses, the exact metrics, wall ms a step,
    collectives a step and the kernel launches of the steps alone.
    before(t) / after(t, loss, metrics) run around step t, untimed and
    uncounted."""
    from wsl4mis_torch import parallel

    from wsl4mis_torch.engine.methods.common import DeviceBatches, split_rngs

    mesh = parallel.current_mesh()
    losses, metrics, calls, step_ms = [], {}, {}, []
    reset_counts()
    for t, batch in enumerate(batches):
        if before is not None:
            before(t)
        if mesh.world_size > 1:
            batch = parallel.shard_batch(mesh, batch, bundle.batch_parts)
        if not cfg.device_data:  # the rank's rows of a host batch
            batch = next(DeviceBatches([batch], dev))
        parallel.calls.clear()
        sync(dev)
        t0 = time.perf_counter()
        rngs = split_rngs(cfg.seed, bundle.state.step, dev)
        m = bundle.step_fn(bundle.state, batch, rngs, bundle.aux)
        if bundle.host_hook is not None:
            bundle.host_hook(bundle, bundle.state, bundle.state.step)
        sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        for k, v in parallel.calls.items():
            calls[k] = calls.get(k, 0) + v
        losses.append(float(m["total_loss"]))
        exact = {k: float(m[k]) for k in DP_EXACT_METRICS if k in m}
        for k, v in exact.items():
            metrics.setdefault(k, []).append(v)
        if after is not None:
            after(t, losses[-1], exact)
    return {"losses": losses, "metrics": metrics, "step_ms": step_ms,
            "ms_per_step": sum(step_ms) / len(step_ms),
            "collectives_per_step": {k: v / len(batches) for k, v in
                                     sorted(calls.items())},
            "launches": launch_counts()}


def dp_leaf_class(path, params):
    """A state leaf's class: params, bn_stats, opt, ema, disc, disc_opt,
    weight (s2l's buffer), memory, gate (the memory's 'initialized') or
    count (the step)."""
    parts = path.split("/")[1:]
    if parts[0] == "model":
        return "params" if parts[1] in params else "bn_stats"
    if parts[0] == "opt":
        return "opt"
    if parts[0] == "extra" and len(parts) > 1:
        if parts[-1] == "initialized":
            return "gate"
        return {"ema_params": "ema", "disc_params": "disc",
                "disc_opt_state": "disc_opt", "weight": "weight"}.get(
            parts[1], "memory")
    return "count"


def dp_compare(method, got, want, params, before=None):
    """({leaf class: the largest absolute difference}, failures) of a
    state's leaves (state_leaves) after a step against the single-process
    ones after the same step from the same state `before`, by the
    tolerances above; `params`: the model's parameter names. The optimizer
    moments (opt, disc_opt) are held by dp_moments where `before` is
    given, else recorded."""
    import torch

    if got.keys() != want.keys():
        return {}, [f"leaves {sorted(got.keys() ^ want.keys())[:5]}"]
    atol = DP_ADAM_ATOL.get(method, DP_SGD_ATOL)
    diff, fails = {}, []
    for path, a in got.items():
        b = want[path]
        cls = dp_leaf_class(path, params)
        if not isinstance(a, torch.Tensor):
            d = 0.0 if a == b else math.inf
            ok = d == 0.0
        else:
            a, b = a.double(), b.double()
            d = float((a - b).abs().max()) if a.numel() else 0.0
            if cls in ("params", "ema", "disc", "weight"):
                ok = d <= atol
            elif cls == "memory":
                ok = d < DP_GATE_FLIP and d <= DP_MEMORY_ATOL
            elif cls == "gate":
                ok = d == 0.0
            elif cls == "bn_stats":
                layer = path.rsplit(".", 1)[0]
                second = (want[layer + ".var"].double()
                          + want[layer + ".mean"].double() ** 2)
                ok = bool(((a - b).abs() <= DP_STATE_RTOL
                           * second.clamp(min=1.0)).all())
            else:  # opt, disc_opt: dp_moments
                ok = True
        diff[cls] = max(diff.get(cls, 0.0), d)
        if not ok:
            fails.append(f"{path} ({cls}) off by {d}")
    if before is not None:
        rel, moment_fails = dp_moments(method, got, want, before, params)
        diff.update(rel)
        fails += moment_fails
    return diff, fails


def dp_moments(method, got, want, before, params):
    """({"opt/mu": r, ...}, failures): for each optimizer moment (SGD's
    momentum, Adam's mu and nu; the model's, and DAN's discriminator's in
    disc_opt), r = ||got - want|| / ||want - before|| over all its
    leaves: the step's change of the moment against the single process's
    change. A first moment is linear in the gradient, so a gradient off by
    a factor, or missing a path, moves r by that share, where Adam's
    parameters hide it (its first update is lr * sign(g)); the few
    elements that reassociation moves across a kink barely move the norm.
    The first moments are held to DP_MOMENT_RTOL, nu recorded."""
    import torch

    num, den = {}, {}
    for path, a in got.items():
        cls = dp_leaf_class(path, params)
        if cls not in ("opt", "disc_opt") or not isinstance(
                a, torch.Tensor) or not a.is_floating_point():
            continue
        parts = path.split("/")
        kind = cls + "/" + parts[parts.index(
            "opt" if cls == "opt" else "disc_opt_state") + 1]
        b, b0 = want[path].double(), before[path].double()
        num[kind] = num.get(kind, 0.0) + float(((a.double() - b) ** 2).sum())
        den[kind] = den.get(kind, 0.0) + float(((b - b0) ** 2).sum())
    rel = {k: math.sqrt(num[k] / den[k]) if den[k] else (
        0.0 if num[k] == 0 else math.inf) for k in num}
    rtol = DP_MOMENT_RTOL.get(method, DP_MOMENT_RTOL[None])
    return rel, [f"{k} changed {r} off the single process's change "
                 f"(relative; limit {rtol})" for k, r in rel.items()
                 if k.split("/")[1] != "nu" and not r <= rtol]


def dp_check_step(method, t, loss, exact, ref, leaves, params):
    """Step t of a rank (its loss, its exact metrics, the state leaves
    after it) against the single-process step t from the same state: the
    loss relative, the metrics exactly, every leaf by dp_compare.
    (differences, failures)."""
    loss_rel = abs(loss - ref["losses"][t]) / max(1.0, abs(ref["losses"][t]))
    fails = [] if loss_rel < DP_LOSS_RTOL else [
        f"step {t}: loss off by {loss_rel} (relative)"]
    for k, v in ref["metrics"].items():
        if exact.get(k) != v[t]:
            fails.append(f"step {t}: {k} {exact.get(k)} != {v[t]}")
    diff, leaf_fails = dp_compare(method, leaves, ref["states"][t + 1],
                                  params, ref["states"][t])
    return {"loss_rel": loss_rel, **diff}, fails + [
        f"step {t}: {f}" for f in leaf_fails]


def dp_digest(leaves):
    """sha256 over a state's leaves in path order (path, dtype, shape,
    bytes): equal digests, bit-equal states."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for path in sorted(leaves):
        v = leaves[path]
        h.update(path.encode())
        if isinstance(v, torch.Tensor):
            t = v.detach().contiguous().cpu()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def _cpu_leaves(leaves):
    import torch

    return {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor)
            else v for k, v in leaves.items()}


def _load_leaves(state, leaves):
    """Copy a snapshot's tensors (state_leaves paths) into the state's."""
    import torch

    with torch.no_grad():
        for path, t in state_leaves(state).items():
            if isinstance(t, torch.Tensor):
                t.copy_(leaves[path])


def dp_rank(rank, spec):
    """One rank of a phase-8 group, a process of its own. With
    spec["reference"], rank 0 first runs every cell with no process group
    (the single-process steps at the global batch) and keeps the state
    before and after each step. Then the rank joins the group
    (parallel.make_mesh; spec["cards"][rank] on the card) and runs every
    cell on its rows, each step from the reference's state before it
    (rank 0 loads it and replicate_tree broadcasts it), so that each step
    is held to the single-process one from the same state, as
    tests/test_sharding.py holds one step (Adam's first update turns
    rounding-level gradient differences into +-lr steps, which the next
    step would compound). Writes {spec["out"]}/rank{rank}.pt: per cell the
    run (dp_steps, the state digest after each step; on rank 0 the largest
    difference a leaf class and the failures) and, with
    spec["keep_states"], the final state leaves on the CPU (rank 0: the
    reference's too) and the model's parameter names."""
    import functools

    import torch

    from wsl4mis_torch import parallel

    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.set_device(spec["cards"][rank])
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    if spec.get("widths"):  # narrow models (the CPU tests)
        from wsl4mis_torch.engine.methods import common
        from wsl4mis_torch.engine.methods import scribblevc as msvc
        from wsl4mis_torch.models import net_factory

        common.net_factory = functools.partial(
            net_factory, features=spec["widths"]["features"])
        msvc.net_factory = functools.partial(
            net_factory, **spec["widths"]["scribblevc"])
    refs = {}
    if rank == 0 and spec["reference"]:
        for cell in spec["cells"]:
            cfg, bundle, batches = dp_bundle(cell, spec)
            states = [_snapshot(state_leaves(bundle.state))]
            refs[cell_key(cell)] = dp_steps(
                cfg, bundle, batches, dev, after=lambda *_: states.append(
                    _snapshot(state_leaves(bundle.state))))
            refs[cell_key(cell)]["states"] = states
            del bundle
    device = f"cuda:{spec['cards'][rank]}" if dev == "cuda" else "cpu"
    parallel.make_mesh(spec["world"], rank, device, spec["init_method"],
                       spec["backend"])
    out = {"rank": rank, "cells": {}, "states": {}, "reference": {},
           "params": {}}
    try:
        for cell in spec["cells"]:
            method, key = cell[0], cell_key(cell)
            cfg, bundle, batches = dp_bundle(cell, spec)
            ref = refs.pop(key, None)
            params = {k for k, _ in bundle.model.named_parameters()}
            digests, diffs, fails = [], {}, []

            def before(t):
                if not spec["reference"]:
                    return
                if ref is not None:
                    _load_leaves(bundle.state, ref["states"][t])
                parallel.replicate_tree(bundle.state.state_dict())

            def after(t, loss, exact):
                leaves = state_leaves(bundle.state)
                digests.append(dp_digest(leaves))
                if ref is not None:
                    d, f = dp_check_step(method, t, loss, exact, ref, leaves,
                                         params)
                    for k, v in d.items():
                        diffs[k] = max(diffs.get(k, 0.0), v)
                    fails.extend(f)

            run = dp_steps(cfg, bundle, batches, dev, before, after)
            run["digests"] = digests
            if ref is not None:
                run.update(diff=diffs, fails=fails, reference={
                    k: ref[k] for k in ("losses", "ms_per_step",
                                        "launches")})
                if spec["keep_states"]:
                    out["reference"][key] = _cpu_leaves(ref["states"][-1])
            if spec["keep_states"]:
                out["states"][key] = _cpu_leaves(state_leaves(bundle.state))
                out["params"][key] = params
            out["cells"][key] = run
            del bundle, ref
            gc.collect()
            if dev == "cuda":
                torch.cuda.empty_cache()
    finally:
        parallel.close_mesh()
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))


def dp_group(world, cells, dev, out, cards=None, backend="gloo",
             reference=True, keep_states=False, hw=HW, dtype="float32",
             seed=0, widths=None):
    """Spawn `world` dp_rank processes (start method spawn) on a file
    rendezvous in `out`; returns their outputs in rank order."""
    import torch
    import torch.multiprocessing as mp

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    spec = {"world": world, "cells": list(cells), "device": dev,
            "cards": cards, "backend": backend, "reference": reference,
            "keep_states": keep_states, "hw": hw, "dtype": dtype,
            "seed": seed, "widths": widths, "out": out,
            "init_method": "file://" + os.path.join(out, "rendezvous")}
    mp.start_processes(dp_rank, args=(spec,), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def dp_expected(cell, steps):
    """A rank's launches over `steps` steps of a cell (s2l: and a refresh
    sweep of its DP_SLICES)."""
    method, model_name = cell[:2]
    out = {k: v * steps for k, v in per_step_counts(model_name,
                                                    method).items()}
    if method == "s2l":
        for k, v in refresh_counts(model_name, DP_SLICES).items():
            out[k] += v
    return out


def dp_verdict(outs, cells, dev):
    """The group's runs: on every rank finite losses, the same state
    digests and, on the card, the launches of its steps (the CPU's plain
    versions launch nothing); on rank 0 no failure against the reference.
    Returns {cell_key: record}."""
    recs = {}
    for cell in cells:
        method = cell_key(cell)
        runs = [o["cells"][method] for o in outs]
        r0 = runs[0]
        digests = {tuple(r["digests"]) for r in runs}
        want = dp_expected(cell, cell_steps(cell))
        expect(dev != "cuda" or all(r["launches"] == want for r in runs),
               f"data parallel {method}: launches "
               f"{[r['launches'] for r in runs]} != {want}")
        expect(all(math.isfinite(v) for r in runs for v in r["losses"]),
               f"data parallel {method}: losses {r0['losses']}")
        expect(len(digests) == 1, f"data parallel {method}: the ranks' "
                                  f"states differ")
        expect(not r0.get("fails"), f"data parallel {method}: against the "
                                    f"single process: {r0.get('fails')}")
        recs[method] = {
            "batch": cell[2], "ranks": len(runs), "diff": r0["diff"],
            "ms_per_step": [r["ms_per_step"] for r in runs],
            "single_ms_per_step": r0["reference"]["ms_per_step"],
            "collectives_per_step": r0["collectives_per_step"],
            "ranks_bit_equal": True,
            "launches": [r["launches"] for r in runs]
            + [r0["reference"]["launches"]]}
    return recs


def dp_nccl_one(seed, dev="cuda", hw=HW, dtype="bfloat16", batch=N,
                steps=DP_NCCL_STEPS, out=None):
    """fully_supervised at `batch` through the library API, `steps` steps
    with no process group and again from the same seed in a group of one
    (NCCL on the card, gloo on the CPU), every collective an NCCL call:
    both states must be bit-equal. The median ms of a step of each, the
    first step of each run left out, and the collectives a step."""
    from wsl4mis_torch import parallel

    cell = dp_cell("fully_supervised", batch) + ({"steps": steps},)
    spec = {"hw": hw, "seed": seed, "dtype": dtype, "device": dev}
    runs = {}
    for grouped in (False, True):
        if grouped:
            parallel.make_mesh(1, 0, dev, "file://" + os.path.join(
                out, "rendezvous"), "nccl" if dev == "cuda" else "gloo")
        try:
            cfg, bundle, batches = dp_bundle(cell, spec)
            run = dp_steps(cfg, bundle, batches, dev)
            run["leaves"] = _snapshot(state_leaves(bundle.state))
            runs[grouped] = run
            del bundle
        finally:
            parallel.close_mesh()
    bad, worst = leaves_diff(runs[True].pop("leaves"),
                             runs[False].pop("leaves"))
    expect(not bad and runs[True]["losses"] == runs[False]["losses"],
           f"data parallel, one NCCL rank: {len(bad)} leaves differ from "
           f"the run without a group (by {worst})")
    expect(runs[True]["launches"] == runs[False]["launches"],
           "data parallel, one NCCL rank: launches differ")
    return {"batch": batch, "dtype": dtype, "steps": steps,
            "leaves_differing": len(bad),
            "ms_per_step": statistics.median(runs[True]["step_ms"][1:]),
            "plain_ms_per_step": statistics.median(
                runs[False]["step_ms"][1:]),
            "collectives_per_step": runs[True]["collectives_per_step"],
            "launches": [runs[True]["launches"], runs[False]["launches"]]}


def dp_launch_records(dp):
    """Phase 8's launch counts as records ({"launches": ...}): every rank's
    and reference run's of (a) and (c), both runs of (b)."""
    counts = [d for r in dp["two_ranks_gloo"].values() for d in
              r["launches"]] + dp["nccl_one_rank"]["launches"] + dp[
        "multi_card"].get("launches", [])
    return [{"launches": d} for d in counts]


def dp_phase(seed, card, dev="cuda", hw=HW, cells=DP_CELLS, widths=None,
             nccl_batch=N, nccl_dtype="bfloat16", host_cells=()):
    """Phase 8: (a) two ranks over gloo (on the card: both on cuda:0)
    against the single-process steps at the global batch, every cell in
    f32; (b) one NCCL rank against no group, bit for bit; (c) with more
    than one card, min(4, cards) NCCL ranks on fully_supervised against
    the single-process steps. host_cells (phase 11's two-rank cells, with
    their own flags and steps) run in (a)'s group after `cells`, so that
    one spawn serves both phases. Prints the data_parallel line."""
    import torch

    t0 = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke", "dp")
    if dev == "cuda":
        torch.cuda.empty_cache()
    cells = list(cells) + list(host_cells)
    outs = dp_group(2, cells, dev, os.path.join(base, "two_ranks"),
                    cards=[0, 0] if dev == "cuda" else None, hw=hw,
                    seed=seed, widths=widths)
    two = dp_verdict(outs, cells, dev)
    nccl_dir = os.path.join(base, "nccl_one")
    shutil.rmtree(nccl_dir, ignore_errors=True)
    os.makedirs(nccl_dir)
    one = dp_nccl_one(seed, dev, hw, nccl_dtype, nccl_batch, out=nccl_dir)
    cards = torch.cuda.device_count() if dev == "cuda" else 0
    multi = {"run": False, "cards": cards}
    if cards > 1:
        world = min(DP_MAX_CARDS, cards)
        fs = [dp_cell("fully_supervised", N)]
        outs = dp_group(world, fs, dev, os.path.join(base, "multi"),
                        cards=list(range(world)), backend="nccl", hw=hw,
                        seed=seed, widths=widths)
        multi.update(run=True, world=world, **dp_verdict(outs, fs, dev)[
            "fully_supervised"])
    else:
        print(f"data parallel: the multi-card run was not run ({cards} "
              f"card{'s' * (cards != 1)})", flush=True)
    out = {"card": card, "two_ranks_gloo": two, "nccl_one_rank": one,
           "multi_card": multi, "phase_s": time.perf_counter() - t0}
    line = {"card": card, "phase_s": out["phase_s"],
            "two_ranks_gloo": {m: {k: r[k] for k in (
                "batch", "diff", "ms_per_step", "single_ms_per_step",
                "collectives_per_step", "ranks_bit_equal")}
                for m, r in two.items()},
            "nccl_one_rank": {k: v for k, v in one.items()
                              if k != "launches"},
            "multi_card": {k: v for k, v in multi.items()
                           if k != "launches"}}
    print("data_parallel " + json.dumps(line), flush=True)
    return out


# ---- phase 9: the rest of the JAX package's public surface -------------------

SURFACE_VOLUMES = 4  # phantom volumes (10 slices, 216x256) test_single_volume scores
SURFACE_AGREE = 0.999  # f32 predictions, card against CPU: least share of voxels
SURFACE_CHUNK = 8  # the f32 comparison's slices a forward (the CPU's too)
VNET_NORMS = ("batchnorm", "groupnorm", "instancenorm")
VNET_SPREAD_THREADS = (1, 2)  # the CPU's own gradient spread, against its default


def _forwards(predictor, volumes):
    """Eval forwards of predict_volume over each of `volumes`: its slices
    padded to the bucket, in chunks."""
    return sum(-(-(-(-v["image"].shape[0] // predictor.bucket)
                   * predictor.bucket) // predictor.chunk) for v in volumes)


def _launched(counts):
    return {k: v for k, v in counts.items() if v}


def surface_single_volume(unet_path, seed, dev="cuda", hw=HW, widths=None,
                          n_volumes=SURFACE_VOLUMES):
    """(a) eval.test_single_volume with a bf16 UNet (the entry phase's
    trained checkpoint) over phantom volumes: each volume's [dice, hd95]
    equal to evaluate_fold's on that volume alone and their mean to
    evaluate_fold's over all, through the same predictor; its launches an
    eval forward's (eval_counts) per chunk; volumes per second. In f32, the
    same weights' predictions on the card against the CPU's (SURFACE_AGREE
    of the voxels)."""
    import copy

    import numpy as np
    import torch

    from wsl4mis_torch.data import synthetic_volumes
    from wsl4mis_torch.eval.val2d import (
        VolumePredictor,
        evaluate_fold,
        test_single_volume,
    )
    from wsl4mis_torch.models import net_factory
    from wsl4mis_torch.utils.checkpoint import load_model_checkpoint

    kw = (widths or {}).get("unet", {})
    vols = synthetic_volumes(n_volumes, 10, 216, 256, seed=seed + 5)
    model = net_factory("unet", 4, dtype=torch.bfloat16, **kw).to(dev)
    load_model_checkpoint(unet_path, model)
    predictor = VolumePredictor(model, (hw, hw), device=dev)
    test_single_volume(vols[0]["image"], vols[0]["label"], predictor, 4)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    per = [test_single_volume(v["image"], v["label"], predictor, 4)
           for v in vols]
    sync(dev)
    wall = time.perf_counter() - t0
    launches = _launched(launch_counts())
    forwards = _forwards(predictor, vols)
    expected = {k: v * forwards for k, v in eval_counts("unet").items()}
    per = np.asarray(per, np.float64)
    alone = np.stack([evaluate_fold(predictor, [v], 4) for v in vols])
    mean = evaluate_fold(predictor, vols, 4)
    rec = {"volumes": n_volumes, "wall_s": wall,
           "volumes_per_s": n_volumes / wall, "metrics": per.tolist(),
           "per_volume_diff": float(np.abs(per - alone).max()),
           "mean_diff": float(np.abs(per.mean(axis=0) - mean).max()),
           "launches": launches, "expected": expected}
    expect(rec["per_volume_diff"] == 0.0 and rec["mean_diff"] == 0.0,
           f"test_single_volume {per.tolist()} against evaluate_fold "
           f"{alone.tolist()} / {mean.tolist()}")
    expect(launches == expected,
           f"test_single_volume launches {launches} != {expected}")
    expect(np.isfinite(per).all() and per[:, :, 0].max() > 0,
           f"test_single_volume: {per.tolist()}")
    ref = net_factory("unet", 4, dtype=torch.float32, **kw)
    load_model_checkpoint(unet_path, ref)
    card = copy.deepcopy(ref).to(dev)
    preds = [VolumePredictor(m, (hw, hw), device=d, chunk=SURFACE_CHUNK)
             .predict_volume(vols[0]["image"])
             for m, d in ((card, dev), (ref, "cpu"))]
    rec["f32_agree"] = float((preds[0] == preds[1]).mean())
    expect(rec["f32_agree"] >= SURFACE_AGREE,
           f"test_single_volume f32: {rec['f32_agree']} of the voxels as "
           f"on the CPU")
    return rec


def surface_apply_model(seed, dev="cuda", hw=HW, batch=N, widths=None):
    """(b) models.init_model / apply_model on a bf16 UNet: apply_model with
    init_model's variables, on another module, bit for bit the first
    module's own forward, eval (K1, K6 forward, the fused BN layers:
    eval_counts) and train (K2 and the fused BN layers: the updated
    batch_stats and the outputs, from the same dropout draws)."""
    import numpy as np
    import torch

    from wsl4mis_torch.models import apply_model, init_model, net_factory
    from wsl4mis_torch.utils.params import _flatten, to_flax_variables

    kw = (widths or {}).get("unet", {})

    def unet(s):
        return net_factory("unet", 4, dtype=torch.bfloat16,
                           generator=_generator(s), **kw).to(dev)

    def draws():
        return torch.Generator(device=dev).manual_seed(seed + 4)

    own, other = unet(seed), unet(seed + 2)
    variables = init_model(own, _generator(seed + 1))
    x = torch.randn((batch, hw, hw, 1), generator=_generator(seed + 3)
                    ).to(dev)
    with torch.no_grad():
        want = own(x, train=False)
        sync(dev)
        reset_counts()
        got = apply_model(other, variables, x, train=False)
        sync(dev)
    eval_launches = _launched(launch_counts())
    want_t = own(x, train=True, rngs={"dropout": draws()})
    want_stats = to_flax_variables(own)["batch_stats"]
    sync(dev)
    reset_counts()
    got_t, got_vars = apply_model(other, variables, x, train=True,
                                  generator=draws())
    sync(dev)
    train_launches = _launched(launch_counts())
    heads, blocks, _ = _unet_sizes("unet")
    want_leaves = dict(_flatten(want_stats))
    got_leaves = dict(_flatten(got_vars["batch_stats"]))
    stats_equal = want_leaves.keys() == got_leaves.keys() and all(
        np.array_equal(want_leaves[k], got_leaves[k]) for k in want_leaves)
    rec = {"batch": batch, "eval_bit_equal": bit_equal(got, want),
           "train_bit_equal": bit_equal(got_t, want_t),
           "batch_stats_equal": stats_equal,
           "batch_stats_leaves": len(got_leaves),
           "eval_launches": eval_launches,
           "eval_expected": eval_counts("unet"),
           "train_launches": train_launches,
           "train_expected": {"conv3x3_fwd_stats": blocks,
                              "conv3x3_fwd": heads, "maxpool_fwd": 4,
                              "bn_act_fwd": blocks}}
    expect(rec["eval_bit_equal"] and rec["train_bit_equal"]
           and stats_equal, f"apply_model against the module: {rec}")
    expect(eval_launches == rec["eval_expected"]
           and train_launches == rec["train_expected"],
           f"apply_model launches: {rec}")
    return rec


def surface_vnet(seed, dev="cuda", shape=ZOO_3D_SHAPE, ref_shape=ZOO_3D_REF,
                 widths=None):
    """(c) VNet with each of VNET_NORMS through check_3d. Instance norm
    over the deepest level's 8 voxels a channel (at 32^3) makes the f32
    gradient ill-conditioned: the CPU against itself moves it by more than
    ZOO_GRAD_TOL between intra-op thread counts, so that gradient is held
    beside the CPU's spread (VNET_SPREAD_THREADS; cpu_spread in the
    surface line)."""
    from wsl4mis_torch.models import VNet

    kw = (widths or {}).get("vnet", {})
    return [check_3d(f"vnet {norm}", lambda dtype, norm=norm: VNet(
        2, normalization=norm, dtype=dtype, generator=_generator(seed + 10),
        **kw), seed, dev, shape, ref_shape,
        VNET_SPREAD_THREADS if norm == "instancenorm" else ())
        for norm in VNET_NORMS]


def surface_checkpoint(seed, base, dev="cuda", hw=HW, widths=None):
    """(d) utils.save_checkpoint of a card UNet's parameters, buffers and a
    bf16 output, then load_checkpoint into a target of card tensors: every
    leaf back bit for bit, on the target's device and dtype."""
    import torch

    from wsl4mis_torch.models import net_factory
    from wsl4mis_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    kw = (widths or {}).get("unet", {})
    model = net_factory("unet", 4, dtype=torch.bfloat16,
                        generator=_generator(seed), **kw).to(dev)
    x = torch.randn((2, hw, hw, 1), generator=_generator(seed + 1)).to(dev)
    with torch.no_grad():
        out = model(x, train=False).to(torch.bfloat16)
    tree = {"params": dict(model.named_parameters()),
            "batch_stats": dict(model.named_buffers()), "logits": out}
    target = {"params": {k: torch.empty_like(v)
                         for k, v in tree["params"].items()},
              "batch_stats": {k: torch.empty_like(v)
                              for k, v in tree["batch_stats"].items()},
              "logits": torch.empty_like(out)}
    path = os.path.join(base, "surface.ckpt")
    t0 = time.perf_counter()
    save_checkpoint(path, tree)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_checkpoint(path, target)
    sync(dev)
    load_s = time.perf_counter() - t0
    pairs = [(tree[c][k], back[c][k]) for c in ("params", "batch_stats")
             for k in tree[c]] + [(out, back["logits"])]
    differing = sum(not (b.device == a.device and b.dtype == a.dtype
                         and torch.equal(a, b)) for a, b in pairs)
    rec = {"leaves": len(pairs), "differing": differing,
           "file_mb": os.path.getsize(path) / 1e6, "save_s": save_s,
           "load_s": load_s}
    expect(differing == 0, f"save_checkpoint / load_checkpoint: {rec}")
    return rec


def surface_svc_multi(svc_run, val, dev="cuda"):
    """(e) test_scribblevc ACDC --checkpoints over the ScribbleVC run's
    checkpoint, the zoo phase's shifted copy and a missing file, on the
    phantom volumes (the command's scoring; this machine may lack h5py):
    MISSING printed; each checkpoint's metrics equal to
    calculate_metric_percase_spacing(..., MULTI_SPACING) over its own
    predictions (the select rule, no class memory), difference 0.0; the
    shifted one predicts foreground, so its HD95 is not 0, and its Dice at
    the cases' own spacing (the single-checkpoint test's) is the same."""
    import contextlib
    import io

    import numpy as np

    from wsl4mis_torch import cli
    from wsl4mis_torch.engine.methods.scribblevc import mean_softmax_decision
    from wsl4mis_torch.eval.infer import load_scribblevc, score_scribblevc
    from wsl4mis_torch.eval.metrics import calculate_metric_percase_spacing
    from wsl4mis_torch.eval.val2d import VolumePredictor

    snap = svc_run["snapshot"]
    names = [f"iter_{svc_run['steps']}.pth", "zoo_shifted.pth",
             "surface_missing.pth"]
    args = cli.scribblevc_test_parser("ACDC").parse_args([
        "--snapshot_root", snap["snapshot_root"], "--exp", snap["exp"],
        "--fold", snap["fold"], "--sup_type", snap["sup_type"],
        "--checkpoints", *names, "--device", dev])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        got = cli.scribblevc_test_scores(args, list(val))
    printed = printed.getvalue()
    expect(list(got) == names[:2] and f"{names[2]} MISSING" in printed,
           f"test_scribblevc --checkpoints: {list(got)}, {printed!r}")
    rec = {"checkpoints": names, "spacing": list(cli.MULTI_SPACING),
           "missing_printed": True}
    for name, path in zip(names[:2], cli.scribblevc_checkpoints(args)):
        model, memory = load_scribblevc(path, args.num_classes,
                                        args.compute_dtype, dev)
        preds = VolumePredictor(
            model, (256, 256), device=dev, decision_fn=mean_softmax_decision,
            forward_kwargs={"use_class_rep": False}).predict_volumes(
            [v["image"] for v in val], {"memory": memory})
        want = np.mean([[calculate_metric_percase_spacing(
            p == i, v["label"] == i, cli.MULTI_SPACING)
            for i in range(1, args.num_classes)]
            for p, v in zip(preds, val)], axis=0)
        rec[name] = {"metrics": got[name].tolist(),
                     "diff": float(np.abs(got[name] - want).max())}
        expect(rec[name]["diff"] == 0.0,
               f"test_scribblevc --checkpoints {name}: {got[name]} != "
               f"{want}")
    shifted = got["zoo_shifted.pth"]
    own = score_scribblevc(cli.scribblevc_inference_config(args), model,
                           memory, list(val))
    rec["shifted_at_case_spacing"] = own.tolist()
    expect(shifted[:, 1].max() > 0 and np.array_equal(own[:, 0],
                                                      shifted[:, 0]),
           f"the shifted checkpoint: {shifted} at (10, 1, 1), {own} at "
           f"the cases' spacing")
    return rec


def surface_phase(seed, val, card, unet_path, svc_run, dev="cuda",
                  hw=HW, batch=N, widths=None, shape3d=ZOO_3D_SHAPE,
                  ref3d=ZOO_3D_REF, n_volumes=SURFACE_VOLUMES):
    """Phase 9 (after phase 7 left cuDNN deterministic, which this phase
    resets): surface_single_volume, surface_apply_model, surface_vnet,
    surface_checkpoint and surface_svc_multi; prints the surface line."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    base = os.path.join(ROOT, "build", "chip_smoke", "surface")
    os.makedirs(base, exist_ok=True)
    out = {"card": card,
           "single_volume": surface_single_volume(unet_path, seed, dev, hw,
                                                  widths, n_volumes),
           "apply_model": surface_apply_model(seed, dev, hw, batch, widths),
           "vnet": surface_vnet(seed, dev, shape3d, ref3d, widths),
           "checkpoint": surface_checkpoint(seed, base, dev, hw, widths),
           "svc_multi": surface_svc_multi(svc_run, val, dev)}
    out["phase_s"] = time.perf_counter() - t0
    sv, am = out["single_volume"], out["apply_model"]
    line = {"card": card, "phase_s": out["phase_s"],
            "test_single_volume": {k: sv[k] for k in (
                "volumes", "volumes_per_s", "per_volume_diff", "mean_diff",
                "f32_agree", "launches")},
            "apply_model": {k: am[k] for k in (
                "eval_bit_equal", "train_bit_equal", "batch_stats_equal",
                "eval_launches", "train_launches")},
            "vnet": [{k: r[k] for k in (
                "model", "fwd_ms", "fwd_bwd_ms", "peak_gb", "ref_err",
                "grad_err", "cpu_spread", "grad_tol") if k in r}
                for r in out["vnet"]],
            "checkpoint": out["checkpoint"],
            "test_scribblevc_checkpoints": out["svc_multi"]}
    print("surface " + json.dumps(line), flush=True)
    return out


def surface_launch_records(surface):
    """Phase 9's launch counts as records: test_single_volume's run and
    apply_model's eval and train calls."""
    am = surface["apply_model"]
    return [{"launches": surface["single_volume"]["launches"]},
            {"launches": am["eval_launches"]},
            {"launches": am["train_launches"]}]


# ---- phase 10: the K-step call, a captured CUDA graph -----------------------


CAPTURE_K = 4  # steps a call
CAPTURE_TIMED = 20  # steps timed eagerly and captured, after the warm-up
# the semi family, DAN, ustm, s2l and scribblevc, whose eager steps are
# the longest: 4 timed steps and one traced call each (scribblevc's cut
# first), to keep the phase's time
CAPTURE_CUT = ("scribblevc", "mean_teacher", "uamt", "entropy_minimization",
               "partially_supervised", "deep_adversarial", "ustm", "s2l")
CAPTURE_TRACED = 2  # calls (of CAPTURE_K steps) in each profile window
CAPTURE_CLI_STEPS = 200  # the train command's run: one validation, at 200
CAPTURE_USTM_CALLS = 3  # ustm's run: 12 steps, every rotation among them
CAPTURE_S2L_START = 4  # s2l's first step; its gate opens two steps later
# the 17 methods at their phase-3 cells: (method, model, batch, data key)
CAPTURE_RUNS = (("fully_supervised", "unet", N, "dense"),
                ("pce", "unet", N, "scribble"),
                ("dmpls", "unet_cct", DMPLS_N, "scribble"),
                ("pce_random_walker", "unet", N, "random_walker"),
                ("pce_tv", "unet", N, "scribble"),
                ("pce_entropy_mini", "unet", N, "scribble"),
                ("pce_gatedcrf", "unet", DMPLS_N, "scribble"),
                ("pce_mumford_shah", "unet", MS_N, "scribble"),
                ("pce_intensity_variance", "unet", N, "scribble"),
                ("mean_teacher", "unet", SEMI_N, "semi"),
                ("uamt", "unet", SEMI_N, "semi"),
                ("entropy_minimization", "unet", SEMI_N, "semi"),
                ("partially_supervised", "unet", SEMI_N, "semi"),
                ("deep_adversarial", "unet", SEMI_N, "semi"),
                ("ustm", "unet", SEMI_N, "scribble"),
                ("s2l", "unet", SEMI_N, "scribble"),
                ("scribblevc", "scribblevc", SVC_N, "svc"))
REMAT_BATCHES = (SVC_N, 2 * SVC_N)  # the remat part's peak GB and ms/step
REMAT_CLI_EPOCHS = 8  # the train_scribblevc command's run (an epoch a step)
# (launch counter, its kernel's name in a trace, demangled or mangled): a
# replay's launches are counted from the trace, since a wrapper counts
# the one launch the capture recorded
TRACE_KERNELS = (
    ("conv3x3_fwd_stats", r"conv3x3_fwd(?:_mma)?_kernel(?:<[^>]*true>|I.*Lb1E)"),
    ("conv3x3_fwd", r"conv3x3_fwd(?:_mma)?_kernel(?:<[^>]*false>|I.*Lb0E)"),
    ("conv3x3_wgrad", r"conv3x3_wgrad(?:_mma)?_kernel"),
    ("augment", r"(?<![_a-z])augment_kernel"),
    ("augment_s2l", r"augment_s2l_kernel"),
    ("maxpool_fwd", r"maxpool_fwd_kernel"),
    ("maxpool_bwd", r"maxpool_bwd_kernel"),
    ("gated_crf", r"gated_crf_kernel"),
    ("bn_act_fwd", r"bn_act_fwd_kernel"),
    ("bn_act_sums", r"bn_act_sums_kernel"),
    ("bn_act_bwd", r"bn_act_bwd_kernel"))


def trace_launches(events):
    """Launches of each counted kernel among a trace's device events."""
    out = {k: 0 for k, _ in TRACE_KERNELS}
    for name, _ in events:
        for key, pattern in TRACE_KERNELS:
            if re.search(pattern, name):
                out[key] += 1
                break
    return out


MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's


def traced_windows(segments, pad):
    """Segments (prep, fn, steps) in one torch.profiler window: pad(),
    then for each segment prep() (if any; untimed, outside the marks) and
    fn(), which runs `steps` steps, between two marker kernels
    (torch.cuda._sleep) of its own, then pad(). A trace can lose the
    records of the first kernels launched after its window opens (on the
    H100, in some eager windows, the first step's augment launches;
    tools/trace_loss_probe.py counts such windows), so only the marked
    segments are read. For each segment its device events between its
    marks, wall ms a step, device busy ms a step and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad()
        torch.cuda.synchronize()
        for prep, fn, _ in segments:
            if prep is not None:
                prep()
                torch.cuda.synchronize()
            torch.cuda._sleep(100)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e6 * (time.perf_counter() - t0))
            torch.cuda._sleep(100)
        pad()
        torch.cuda.synchronize()
    timed = sorted(
        (e.start_ns(), e.name(), 1e-3 * e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_hidden_event", lambda: False)())
    marks = [i for i, (_, name, _) in enumerate(timed)
             if MARKER_KERNEL in name]
    expect(len(marks) == 2 * len(segments),
           f"trace: {len(marks)} marker kernels, not {2 * len(segments)}")
    out = []
    for n, ((_, _, steps), wall_us) in enumerate(zip(segments, walls)):
        events = [(name, us) for _, name, us in
                  timed[marks[2 * n] + 1:marks[2 * n + 1]]]
        busy_us = sum(us for _, us in events)
        out.append((events, {"ms_per_step": 1e-3 * wall_us / steps,
                             "device_busy_ms_per_step":
                                 1e-3 * busy_us / steps,
                             "device_busy_share": busy_us / wall_us}))
    return out


def _metrics_leaves(m, prefix=""):
    out = {}
    for k, v in m.items():
        if isinstance(v, dict):
            out.update(_metrics_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().clone()
    return out


def _restore(state, leaves):
    """The state as a state_leaves snapshot holds it (tensors and host
    counts)."""
    _load_leaves(state, leaves)
    state.set_host_counts({k: leaves["/" + k] for k in state.host_counts()})


def variant_picks(bundle, seed, start, steps):
    """The bundle's variant key (engine.graph.CapturedStep.pick's) of each
    step from `start` on, picked on the host."""
    if bundle.variant is None:
        return [()] * steps
    probe = type("HostState", (), {})()
    out = []
    for n in range(start, start + steps):
        probe.step = n
        out.append(tuple(sorted(bundle.variant(probe, seed).items())))
    return out


def replay_reorders(picks):
    """Whether a graph captured earlier is replayed after one captured
    later: the capture index of the steps' variants is not monotone."""
    order = list(dict.fromkeys(picks))
    idx = [order.index(p) for p in picks]
    return any(a > b for a, b in zip(idx, idx[1:]))


def ustm_start(seed, steps, limit=400):
    """The first step from which `steps` ustm steps take all four rotations
    and replay a graph after a later-captured one."""
    from wsl4mis_torch.engine.methods.ustm import variant

    bundle = type("Bundle", (), {"variant": staticmethod(variant)})()
    for start in range(limit):
        picks = variant_picks(bundle, seed, start, steps)
        if len(set(picks)) == 4 and replay_reorders(picks):
            return start
    raise Failure(f"ustm: no {steps}-step window from steps 0..{limit} "
                  f"takes all four rotations")


def capture_run(method, model_name, batch, data, seed, dev="cuda", hw=HW,
                k=CAPTURE_K, timed=CAPTURE_TIMED, traced=CAPTURE_TRACED,
                calls=1, start=0, flags=None, refresh=False):
    """One captured method: from one state at step `start`, k * calls eager
    steps and `calls` k-step calls of engine.graph.CapturedStep on the same
    batches, every leaf and each call's metrics bit-equal; the variants
    picked and captured (their order, whether a replay reorders them); the
    wrappers' counts of the warm-ups and captures; ms/step eager against
    captured over `timed` steps; `traced` calls and as many eager steps as
    two marked segments of one profile window (busy share, and each
    kernel's launches from the
    trace: per_step_counts a step, for both); capture seconds of each
    variant and peak GB. `flags`: more TrainConfig fields; `refresh`: run
    s2l's host hook once first (a live pseudo-label buffer)."""
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.graph import WARMUP_STEPS, CapturedStep
    from wsl4mis_torch.engine.methods.common import split_rngs

    t_run = time.perf_counter()
    parts = {}

    def part(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    cfg = TrainConfig(
        method=method, model=model_name, batch_size=batch,
        labeled_bs=batch // 2, max_iterations=10 ** 4,
        compute_dtype="bfloat16", seed=seed, device=dev, patch_size=(hw, hw),
        sup_type=sup_type_of(method), **(flags or {}))
    bundle, new_batches = method_bundle(cfg, data, None)
    state, step_fn, aux = bundle.state, bundle.step_fn, bundle.aux
    if refresh:
        bundle.host_hook(bundle, state, cfg.period_iter)
    state.set_host_counts({key: start for key in state.host_counts()})
    it = new_batches()
    batches = [next(it) for _ in range(k * calls)]
    picks = variant_picks(bundle, seed, start, k * calls)
    t_part = part("build", t_run)

    def eager(n):
        for i in range(n):
            m = step_fn(state, batches[i % len(batches)],
                        split_rngs(seed, state.step, dev), aux)
        return m

    start_leaves = _snapshot(state_leaves(state))
    torch.cuda.reset_peak_memory_stats()
    want_metrics = []
    for _ in range(calls):
        want_metrics.append(_metrics_leaves(eager(k)))
        batches = batches[k:] + batches[:k]
    sync(dev)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    want = _snapshot(state_leaves(state))
    _restore(state, start_leaves)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_part = part("eager", t_part)
    reset_counts()
    captured = CapturedStep(step_fn, state, aux, seed, bundle.variant)
    got_metrics = [_metrics_leaves(captured(batches[c * k:(c + 1) * k]))
                   for c in range(calls)]
    sync(dev)
    t_part = part("captured", t_part)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = _snapshot(state_leaves(state))
    bad, worst = leaves_diff(want, got)
    bad_metrics = sorted({key for w, g in zip(want_metrics, got_metrics)
                          for key, v in w.items()
                          if not torch.equal(v, g[key])})
    per = per_step_counts(model_name, method)
    graphs = len(captured.graphs)
    expected = {key: v * (WARMUP_STEPS + 1) * graphs
                for key, v in per.items()}

    def captured_calls(n):
        for _ in range(n):
            captured(batches[:k])

    ms = {}
    for name, fn in (("eager", eager), ("captured", lambda n: captured_calls(
            n // k))):
        sync(dev)
        t0 = time.perf_counter()
        fn(timed)
        sync(dev)
        ms[name] = 1e3 * (time.perf_counter() - t0) / timed
    graphs_after = len(captured.graphs)
    t_part = part("timed", t_part)
    steps = k * traced
    (ev_eager, prof_eager), (ev_cap, prof_cap) = traced_windows(
        [(None, lambda: eager(steps), steps),
         (None, lambda: captured_calls(traced), steps)], lambda: eager(1))
    per_call = {key: v * k for key, v in per.items()}
    eager_trace = trace_launches(ev_eager)
    cap_trace = trace_launches(ev_cap)
    part("traced", t_part)
    rec = {"method": method, "model": model_name, "batch": batch, "k": k,
           "calls": calls, "start": start,
           "variants": [str(dict(p)) for p in dict.fromkeys(picks)],
           "replay_reorders": replay_reorders(picks),
           "graphs": graphs, "graphs_after_timing": len(captured.graphs),
           "leaves": len(want), "leaves_differing": bad,
           "max_abs_diff": worst, "metrics_differing": bad_metrics,
           "launches": counts, "expected": expected,
           "trace_launches_per_call": {key: v / traced for key, v in
                                       cap_trace.items()},
           "expected_per_call": per_call,
           "eager_trace_launches_per_step": {key: v / steps for key, v in
                                             eager_trace.items()},
           "timed": timed, "eager_ms_per_step": ms["eager"],
           "captured_ms_per_step": ms["captured"],
           "profile_eager": prof_eager, "profile_captured": prof_cap,
           "capture_s": {str(dict(key)): v for key, v in
                         captured.capture_s.items()},
           "eager_peak_gb": eager_peak, "captured_peak_gb": peak,
           "parts_s": parts}
    del captured
    rec["run_s"] = time.perf_counter() - t_run
    print("captured-run " + json.dumps(rec), flush=True)
    expect(not bad and not bad_metrics,
           f"{method}: {calls} captured call(s) differ from {k * calls} "
           f"eager steps in {bad[:8]} (max {worst}) and metrics "
           f"{bad_metrics}")
    expect(graphs == len(set(picks)) == graphs_after,
           f"{method}: {graphs} graphs ({graphs_after} after timing) for "
           f"the variants {rec['variants']}")
    expect(counts == expected,
           f"{method}: warm-up + capture launches {counts} != {expected}")
    expect(cap_trace == {key: v * traced for key, v in per_call.items()},
           f"{method}: replay launches {rec['trace_launches_per_call']} a "
           f"call != {per_call}")
    expect(eager_trace == {key: v * steps for key, v in per.items()},
           f"{method}: the trace's eager launches {eager_trace} over "
           f"{steps} steps != per_step_counts {per}")
    return rec


def gate_spec(method, batch, n_slices):
    """Where a run of s2l or scribblevc starts so that its first k = 4
    steps cross its gate: s2l from two steps before its gate opens (a
    refresh first, thr_conf 0.04: its pseudo-label term live),
    scribblevc from two steps before its memory gate opens."""
    if method == "s2l":
        return {"start": CAPTURE_S2L_START, "refresh": True,
                "flags": {"thr_iter": CAPTURE_S2L_START + 2,
                          "thr_conf": 0.04}}
    if method == "scribblevc":
        return {"start": svc_gate_step(n_slices, batch) - 2}
    return {}


def capture_spec(method, batch, seed, n_slices):
    """capture_run's keyword arguments for a method: where its run starts
    and how many calls it takes so that it crosses its variants."""
    out = gate_spec(method, batch, n_slices)
    if method in CAPTURE_CUT:
        out.update(timed=CAPTURE_K, traced=1)
    if method == "ustm":
        calls = CAPTURE_USTM_CALLS
        out.update(calls=calls, start=ustm_start(seed, CAPTURE_K * calls))
    return out


def _svc_steps(bundle, batches, seed, dev, n):
    from wsl4mis_torch.engine.methods.common import split_rngs

    state = bundle.state
    for i in range(n):
        m = bundle.step_fn(state, batches[i % len(batches)],
                           split_rngs(seed, state.step, dev), bundle.aux)
    return m


def remat_cell(data, batch, seed, dev="cuda", hw=HW, k=CAPTURE_K,
               check=False):
    """ScribbleVC at `batch` with cfg.remat: from one state two steps before
    the memory gate opens, k eager steps with remat and without (peak GB
    of each, and the peak above the resident state; with `check`, every
    leaf and metric bit-equal, and one captured k-step remat call
    bit-equal to the eager remat steps); then, gate open, the captured
    ms/step of each (k replays timed after the capture) and its peak. The
    snapshots are kept on the host, so that both peaks see the same
    resident tensors."""
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.graph import WARMUP_STEPS, CapturedStep

    cfg = TrainConfig(
        method="scribblevc", model="scribblevc", batch_size=batch,
        max_iterations=10 ** 4, compute_dtype="bfloat16", seed=seed,
        device=dev, patch_size=(hw, hw), sup_type="scribble", remat=True)
    bundle, new_batches = method_bundle(cfg, data, None)
    state, model = bundle.state, bundle.model
    start = svc_gate_step(len(data), batch) - 2
    state.set_host_counts({key: start for key in state.host_counts()})
    it = new_batches()
    batches = [next(it) for _ in range(k)]
    start_leaves = _cpu_leaves(state_leaves(state))
    out, leaves, metrics = {"batch": batch, "start": start, "k": k}, {}, {}
    for remat in (True, False):
        model.remat = remat
        _restore(state, start_leaves)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        metrics[remat] = {key: v.cpu() for key, v in _metrics_leaves(
            _svc_steps(bundle, batches, seed, dev, k)).items()}
        sync(dev)
        peak = torch.cuda.max_memory_allocated()
        out[f"eager_peak_gb_remat{int(remat)}"] = peak / 1e9
        out[f"eager_above_resident_gb_remat{int(remat)}"] = \
            (peak - resident) / 1e9
        leaves[remat] = _cpu_leaves(state_leaves(state))
    if check:
        bad, worst = leaves_diff(leaves[False], leaves[True])
        out.update(leaves=len(leaves[True]), remat_leaves_differing=bad,
                   remat_max_abs_diff=worst, remat_metrics_differing=sorted(
                       key for key, v in metrics[True].items()
                       if not torch.equal(v, metrics[False][key])))
        model.remat = True
        _restore(state, start_leaves)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_counts()
        captured = CapturedStep(bundle.step_fn, state, bundle.aux, seed,
                                bundle.variant)
        got_metrics = {key: v.cpu() for key, v in _metrics_leaves(
            captured(batches)).items()}
        sync(dev)
        counts = launch_counts()
        bad_c, worst_c = leaves_diff(leaves[True],
                                     _cpu_leaves(state_leaves(state)))
        expected = {key: v * (WARMUP_STEPS + 1) * len(captured.graphs)
                    for key, v in per_step_counts("scribblevc").items()}
        out.update(captured_graphs=len(captured.graphs),
                   captured_leaves_differing=bad_c,
                   captured_max_abs_diff=worst_c,
                   captured_metrics_differing=sorted(
                       key for key, v in metrics[True].items()
                       if not torch.equal(v, got_metrics[key])),
                   launches=counts, expected=expected)
        del captured
    for remat in (True, False):  # the gate open: one graph each
        model.remat = remat
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        captured = CapturedStep(bundle.step_fn, state, bundle.aux, seed,
                                bundle.variant)
        captured(batches)
        sync(dev)
        t0 = time.perf_counter()
        captured(batches)
        sync(dev)
        out[f"captured_ms_per_step_remat{int(remat)}"] = \
            1e3 * (time.perf_counter() - t0) / k
        peak = torch.cuda.max_memory_allocated()
        out[f"captured_peak_gb_remat{int(remat)}"] = peak / 1e9
        out[f"captured_above_resident_gb_remat{int(remat)}"] = \
            (peak - resident) / 1e9
        del captured
    if check:
        expect(not out["remat_leaves_differing"]
               and not out["remat_metrics_differing"],
               f"remat b{batch}: {k} eager steps differ from remat 0 in "
               f"{out['remat_leaves_differing'][:8]} (max "
               f"{out['remat_max_abs_diff']}), metrics "
               f"{out['remat_metrics_differing']}")
        expect(out["captured_graphs"] == 2
               and not out["captured_leaves_differing"]
               and not out["captured_metrics_differing"],
               f"remat b{batch}: the captured call ({out['captured_graphs']} "
               f"graphs) differs from its eager steps in "
               f"{out['captured_leaves_differing'][:8]}, metrics "
               f"{out['captured_metrics_differing']}")
        expect(out["launches"] == out["expected"],
               f"remat b{batch}: launches {out['launches']} != "
               f"{out['expected']}")
    return out


def remat_cli(seed, data, val, dev="cuda", hw=HW, k=CAPTURE_K,
              epochs=REMAT_CLI_EPOCHS):
    """train_scribblevc ACDC --steps_per_call k over `epochs` epochs (a step
    each on SVC_SLICES slices at batch 6, the memory gate opening at the
    sixth), with --remat 1 and with --remat 0 (cli.scribblevc_main, the
    bundle from in-memory data): both captured (two graphs), the final
    states bit-equal."""
    from wsl4mis_torch import cli
    from wsl4mis_torch.engine.trainer import Trainer

    snap = os.path.join(ROOT, "build", "chip_smoke", "remat_cli")
    made = []

    class InMemory:
        @staticmethod
        def build(cfg):
            return method_bundle(cfg, data, val)[0]

    def trainer(cfg, bundle, use_tensorboard=True):
        made.append(Trainer(cfg, bundle, use_tensorboard=False))
        return made[-1]

    runs = {}
    saved = cli.get_method, cli.Trainer
    cli.get_method, cli.Trainer = (lambda name: InMemory), trainer
    try:
        for remat in (1, 0):
            argv = ["--batch_size", str(SVC_N), "--max_epoches", str(epochs),
                    "--val_every_epoches", "1000", "--ckpt_epoches", "1000",
                    "--seed", str(seed), "--patch_size", f"[{hw}, {hw}]",
                    "--snapshot_root", os.path.join(snap, str(remat)),
                    "--steps_per_call", str(k), "--remat", str(remat),
                    "--device", dev]
            reset_counts()
            t0 = time.perf_counter()
            cli.scribblevc_main(argv, "ACDC")
            sync(dev)
            t = made[-1]
            runs[remat] = {
                "wall_s": time.perf_counter() - t0,
                "remat": t.cfg.remat, "steps": t.state.step,
                "graphs": len(t.captured.graphs) if t.captured else 0,
                "launches": launch_counts(),
                "leaves": _snapshot(state_leaves(t.state))}
            made[-1] = None
            gc.collect()
    finally:
        cli.get_method, cli.Trainer = saved
    bad, worst = leaves_diff(runs[1].pop("leaves"), runs[0].pop("leaves"))
    rec = {"epochs": epochs, "k": k, "runs": runs, "leaves_differing": bad,
           "max_abs_diff": worst}
    expect(all(r["graphs"] == 2 and r["steps"] == epochs
               for r in runs.values())
           and runs[1]["remat"] and not runs[0]["remat"],
           f"train_scribblevc --remat: {runs}")
    expect(not bad, f"train_scribblevc --remat 1 ends off --remat 0 in "
                    f"{bad[:8]} (max {worst})")
    return rec


def remat_part(seed, svc_data, val, dev="cuda", hw=HW, widths=None):
    """The remat part of phase 10: remat_cell at each of REMAT_BATCHES (the
    first with its checks) and remat_cli."""
    import torch

    from wsl4mis_torch.data import synthetic_slices

    t0 = time.perf_counter()
    cells = []
    for batch in REMAT_BATCHES:
        data = svc_data if batch == SVC_N else synthetic_slices(
            2 * batch, (hw, hw), seed=seed + 2, sup_type="scribble")
        check = batch == SVC_N  # the larger batch: its memory and time
        cells.append(remat_cell(data, batch, seed, dev, hw,
                                k=CAPTURE_K if check else 2, check=check))
        gc.collect()
        torch.cuda.empty_cache()
    cli_rec = remat_cli(seed, svc_data, val, dev, hw)
    return {"cells": cells, "cli": cli_rec, "s": time.perf_counter() - t0}


def capture_cli(seed, data, val, eager_dice, dev="cuda", hw=HW,
                steps=CAPTURE_CLI_STEPS, k=CAPTURE_K, extra=(),
                name="captured_cli"):
    """The train command, fully_supervised b24, with --steps_per_call k
    --val_every 200 (log_every rounded to a multiple of k) and the `extra`
    flags: the call captured (the log says so), one validation at 200,
    the checkpoints, the launches of the warm-up, the capture and the
    validation, and the val Dice equal to phase 5's eager run of the same
    argv at step 200 (`eager_dice`; None: not compared): the same states,
    bit for bit."""
    import numpy as np

    from wsl4mis_torch.engine.graph import WARMUP_STEPS

    snap = os.path.join(ROOT, "build", "chip_smoke", name)
    argv = entry_argv(N, steps, steps, snap, seed, hw) + [
        "--steps_per_call", str(k), "--device", dev, *extra]
    trainer = cli_trainer("train_fully_supervised_2D", argv, data, val)
    cfg = trainer.cfg
    vals, losses, val_s = [], [], []
    validate, call = trainer.validate, trainer._call

    def recording_validate(it):
        t0 = time.perf_counter()
        out = validate(it)
        vals.append((it, out[0]))
        val_s.append(time.perf_counter() - t0)
        return out

    def recording_call(batches, it):
        m = call(batches, it)
        losses.append(m["total_loss"])
        return m

    trainer.validate, trainer._call = recording_validate, recording_call
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    trainer.train()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {key: v * (WARMUP_STEPS + 1) for key, v in per_step_counts(
        "unet", cfg.method).items()}
    depth = sum(-(-v["image"].shape[0] // 8) * 8 for v in val)
    for key, v in eval_counts("unet").items():
        expected[key] += v * -(-depth // EVAL_N) * len(vals)
    with open(os.path.join(cfg.snapshot_path, "log.txt")) as f:
        logged = [line.strip() for line in f if "steps_per_call" in line]
    loss_vals = [float(v) for v in losses]
    capture_s = (sum(trainer.captured.capture_s.values())
                 if trainer.captured else None)
    rec = {"extra": list(extra), "steps": steps, "k": k,
           "val_every": trainer.val_every,
           "log_every": trainer.log_every, "vals": vals, "logged": logged,
           "launches": counts, "expected": expected, "losses": loss_vals,
           "eager_dice": eager_dice, "wall_s": wall, "val_s": sum(val_s),
           "capture_s": capture_s,
           "ms_per_step": 1e3 * (wall - sum(val_s)) / steps}
    expect(trainer.captured is not None and any(
        "captured in a CUDA graph" in line for line in logged),
        f"train command: not captured ({logged})")
    expect([it for it, _ in vals] == [steps] and eager_dice in (
        None, vals[0][1]), f"train command: validations {vals}, phase 5's "
                           f"Dice {eager_dice}")
    expect(counts == expected, f"train command: launches {counts} != "
                               f"{expected}")
    expect(len(loss_vals) == steps // k and all(np.isfinite(loss_vals)),
           f"train command: losses {loss_vals}")
    for name in (f"iter_{steps}.pth", "latest_full.ckpt",
                 f"{cfg.model}_best_model.pth"):
        expect(os.path.isfile(os.path.join(cfg.snapshot_path, name)),
               f"train command: checkpoint {name} missing")
    return rec


def capture_profile(seed, data, dev="cuda", hw=HW, k=2, n=4):
    """--profile_steps n under capture: fully_supervised b24 through the
    Trainer at K = k (dividing 10, so that the window opens) for 10 + n
    steps; the trace file holds the replays' kernels: of every kernel of
    the step, n steps' launches (per_step_counts), less at most one step's
    (a trace can lose the first launches after its window opens; see
    traced_window)."""
    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.trainer import Trainer

    snap = os.path.join(ROOT, "build", "chip_smoke", "captured_profile")
    cfg = TrainConfig(
        method="fully_supervised", model="unet", batch_size=N,
        max_iterations=10 + n, val_every=10 ** 9, ckpt_every=10 ** 9,
        compute_dtype="bfloat16", seed=seed, device=dev,
        patch_size=(hw, hw), sup_type="label", snapshot_root=snap,
        steps_per_call=k, profile_steps=n)
    bundle, _ = method_bundle(cfg, data, None)
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    trainer.train()
    path = os.path.join(cfg.snapshot_path, "profile", "trace.json")
    with open(path) as f:
        events = [(e["name"], e.get("dur", 0.0))
                  for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    launches = trace_launches(events)
    per = per_step_counts("unet", cfg.method)
    expected = {key: v * n for key, v in per.items()}
    rec = {"k": k, "steps": n, "trace_mb": os.path.getsize(path) / 1e6,
           "kernel_events": len(events), "launches": launches,
           "expected": expected}
    expect(trainer.captured is not None and all(
        (n - 1) * v <= launches[key] <= n * v for key, v in per.items()),
        f"profile under capture: {launches}, not {expected} less at most "
        f"one step's")
    return rec


def capture_phase(seed, datasets, val, card, eager_dice, dev="cuda", hw=HW):
    """Phase 10: capture_run for the 17 methods, the remat part,
    capture_cli, capture_profile; the captured line."""
    import torch

    t0 = time.perf_counter()
    runs = []
    for method, model_name, batch, key in CAPTURE_RUNS:
        data = datasets[key]
        runs.append(capture_run(
            method, model_name, batch, data, seed, dev, hw,
            **capture_spec(method, batch, seed, len(data))))
        gc.collect()
        torch.cuda.empty_cache()
    remat = remat_part(seed, datasets["svc"], val, dev, hw)
    cli_run = capture_cli(seed, datasets["dense"], val, eager_dice, dev, hw)
    prof = capture_profile(seed, datasets["dense"], dev, hw)
    out = {"card": card, "runs": runs, "remat": remat, "cli": cli_run,
           "profile": prof, "phase_s": time.perf_counter() - t0}
    line = {"card": card, "phase_s": out["phase_s"], "k": CAPTURE_K,
            "runs": [{key: r[key] for key in (
                "method", "batch", "start", "calls", "variants",
                "replay_reorders", "leaves", "leaves_differing",
                "metrics_differing", "timed", "eager_ms_per_step",
                "captured_ms_per_step", "capture_s", "eager_peak_gb",
                "captured_peak_gb", "run_s")}
                | {"busy_share_eager":
                   r["profile_eager"]["device_busy_share"],
                   "busy_share_captured":
                   r["profile_captured"]["device_busy_share"],
                   "busy_ms_eager":
                   r["profile_eager"]["device_busy_ms_per_step"],
                   "busy_ms_captured":
                   r["profile_captured"]["device_busy_ms_per_step"],
                   "replay_launches_per_call":
                   r["trace_launches_per_call"]}
                for r in runs],
            "remat": {"cells": [{key: v for key, v in c.items()
                                 if key not in ("launches", "expected")}
                                for c in remat["cells"]],
                      "cli": {"leaves_differing":
                              remat["cli"]["leaves_differing"],
                              "wall_s": {r: v["wall_s"] for r, v in
                                         remat["cli"]["runs"].items()}},
                      "s": remat["s"]},
            "cli": {key: cli_run[key] for key in (
                "steps", "val_every", "log_every", "vals", "eager_dice",
                "ms_per_step", "capture_s", "wall_s")},
            "profile_steps": {key: prof[key] for key in (
                "k", "steps", "trace_mb", "launches")}}
    print("captured " + json.dumps(line), flush=True)
    return out

# ---- phase 11: host-fed batches (--device_data 0) and debug_nans -------------

DD_K = CAPTURE_K  # steps compared a method: eager, and one captured call
# the two-rank part: a UNet method whose batch has two parts, and
# scribblevc with its category rows
DD_DP_CELLS = (("uamt", "unet", SEMI_N, "semi"),
               ("scribblevc", "scribblevc", SVC_N, "svc"))
DD_DP_STEPS = 1  # each held to the single process's from the same state


def host_fed(cell):
    """A data-parallel cell as phase 11 runs it: host-fed batches,
    DD_DP_STEPS steps (cell_opts)."""
    return cell[:4] + ({"flags": {"device_data": False},
                        "steps": DD_DP_STEPS},)


# phase 8's two-rank group runs these after its own cells
DD_HOST_CELLS = tuple(map(host_fed, DD_DP_CELLS))
DD_NAN_STEPS = 4  # fs b24 steps timed with and without debug_nans


def device_data_run(method, model_name, batch, data, seed, dev="cuda",
                    hw=HW, k=DD_K, start=0, flags=None, refresh=False):
    """One method with host-fed batches: its bundle with device_data True
    and with False from one state at step `start`, each on its own stream
    (the same slices); k eager steps of each, and one k-step captured call
    (engine.graph.CapturedStep; on the card) of the host-fed one, every
    leaf and metric of each bit-equal to the staged eager steps. On the
    card the captured call and its check come first; then the host-fed
    eager steps and the captured call, replayed from the same state, run
    as two marked segments of one profile window (traced_windows, padded
    by staged steps): ms/step and busy share of each, and the launches,
    per_step_counts a step (the trace's of the host-fed steps; the
    counters' with the two pads)."""
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.graph import CapturedStep
    from wsl4mis_torch.engine.methods.common import split_rngs

    t_run = time.perf_counter()
    bundles, batches = {}, {}
    for staged in (True, False):
        cfg = TrainConfig(
            method=method, model=model_name, batch_size=batch,
            labeled_bs=batch // 2, max_iterations=10 ** 4,
            compute_dtype="bfloat16", seed=seed, device=dev,
            patch_size=(hw, hw), sup_type=sup_type_of(method),
            device_data=staged, **(flags or {}))
        bundle, new_batches = method_bundle(cfg, data, None)
        it = new_batches()
        batches[staged] = [next(it) for _ in range(k)]
        bundles[staged] = bundle
    st, fed = bundles[True], bundles[False]
    expect(fed.aux is None and all(
        "image" in b and "index" not in b or method == "s2l"
        for b in batches[False]), f"{method}: device_data 0 staged a stack "
                                  f"or fed index batches")
    if refresh:
        st.host_hook(st, st.state, cfg.period_iter)
    st.state.set_host_counts({key: start for key in st.state.host_counts()})
    start_leaves = _snapshot(state_leaves(st.state))
    _restore(fed.state, start_leaves)

    def eager(bundle, bs, n):
        for i in range(n):
            m = bundle.step_fn(bundle.state, bs[i % len(bs)],
                               split_rngs(seed, bundle.state.step, dev),
                               bundle.aux)
        return m

    want_metrics = _metrics_leaves(eager(st, batches[True], k))
    want = _snapshot(state_leaves(st.state))
    state, got = fed.state, {}
    per = per_step_counts(model_name, method)

    def fed_eager():
        got["metrics"] = _metrics_leaves(eager(fed, batches[False], k))

    def pad():  # a staged step: it moves the staged state, compared already
        eager(st, batches[True], 1)

    def differing(leaves, metrics):
        bad, worst = leaves_diff(want, leaves)
        return bad, worst, sorted(key for key, v in want_metrics.items()
                                  if not torch.equal(v, metrics[key]))

    cap_bad = ([], 0.0, [])
    if dev == "cuda":  # the captured call first, so that one trace times both
        captured = CapturedStep(fed.step_fn, state, None, seed, fed.variant)
        cap_metrics = _metrics_leaves(captured(batches[False]))
        sync(dev)
        cap_bad = differing(_snapshot(state_leaves(state)), cap_metrics)
        _restore(state, start_leaves)
    reset_counts()
    if dev == "cuda":
        def again():  # the eager steps' state kept, the start put back
            got["leaves"] = _snapshot(state_leaves(state))
            _restore(state, start_leaves)  # the same steps: graphs exist

        (ev_eager, prof_eager), (_, prof_cap) = traced_windows(
            [(None, fed_eager, k),
             (again, lambda: captured(batches[False]), k)], pad)
    else:
        fed_eager()
        got["leaves"] = _snapshot(state_leaves(state))
    sync(dev)
    counts = launch_counts()  # the replays are not counted
    pads = 2 if dev == "cuda" else 0
    expected = {key: v * (k + pads) for key, v in per.items()}
    eager_bad = differing(got["leaves"], got["metrics"])
    rec = {"method": method, "model": model_name, "batch": batch, "k": k,
           "start": start, "leaves": len(want),
           "eager_leaves_differing": eager_bad[0],
           "eager_metrics_differing": eager_bad[2],
           "launches": counts, "expected": expected}
    if dev == "cuda":
        rec.update(eager_trace_launches=trace_launches(ev_eager),
                   graphs=len(captured.graphs),
                   capture_s=sum(captured.capture_s.values()),
                   eager_ms_per_step=prof_eager["ms_per_step"],
                   captured_ms_per_step=prof_cap["ms_per_step"],
                   busy_share_eager=prof_eager["device_busy_share"],
                   busy_share_captured=prof_cap["device_busy_share"])
        del captured
    del st, bundles
    rec.update(captured_leaves_differing=cap_bad[0],
               captured_metrics_differing=cap_bad[2],
               run_s=time.perf_counter() - t_run)
    print("device-data-run " + json.dumps(rec), flush=True)
    expect(not eager_bad[0] and not eager_bad[2],
           f"{method}: {k} host-fed eager steps differ from the staged ones "
           f"in {eager_bad[0][:8]} (max {eager_bad[1]}) and metrics "
           f"{eager_bad[2]}")
    expect(not cap_bad[0] and not cap_bad[2],
           f"{method}: the host-fed captured call differs from the staged "
           f"eager steps in {cap_bad[0][:8]} (max {cap_bad[1]}) and "
           f"metrics {cap_bad[2]}")
    expect(dev != "cuda" or counts == expected and rec[
        "eager_trace_launches"] == {key: v * k for key, v in per.items()},
        f"{method}: launches {counts} != {expected} (the host-fed steps and "
        f"two staged pads), or the trace's host-fed "
        f"{rec.get('eager_trace_launches')} not {k} steps' {per}")
    return rec


def debug_nans_part(seed, data, dev="cuda", hw=HW, batch=N,
                    steps=DD_NAN_STEPS):
    """fully_supervised (host-fed, bf16) under debug_nans
    (engine.debug_nans.NanCheck): `steps` checked steps bit-equal to the
    plain steps from one state, the ms/step of each; then a NaN in one
    input pixel (the centre, which every augmentation keeps) raises
    FloatingPointError naming a module of the model, and leaves the state
    as it was before the step."""
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.debug_nans import NanCheck
    from wsl4mis_torch.engine.methods.common import split_rngs

    cfg = TrainConfig(
        method="fully_supervised", model="unet", batch_size=batch,
        max_iterations=10 ** 4, compute_dtype="bfloat16", seed=seed,
        device=dev, patch_size=(hw, hw), sup_type="label",
        device_data=False)
    bundle, new_batches = method_bundle(cfg, data, None)
    state, step_fn = bundle.state, bundle.step_fn
    it = new_batches()
    batches = [next(it) for _ in range(steps)]
    start = _snapshot(state_leaves(state))
    check = NanCheck(step_fn, seed, torch.device(dev))
    step_fn(state, batches[0], split_rngs(seed, 0, dev), None)  # warm-up
    runs = {}
    for checked in (False, True):
        _restore(state, start)
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        for b in batches:
            if checked:
                m = check(state, b, None, state.step)
            else:
                m = step_fn(state, b, split_rngs(seed, state.step, dev), None)
        sync(dev)
        runs[checked] = {"ms": 1e3 * (time.perf_counter() - t0) / steps,
                         "launches": launch_counts(),
                         "leaves": _snapshot(state_leaves(state)),
                         "metrics": _metrics_leaves(m)}
    bad, worst = leaves_diff(runs[False]["leaves"], runs[True]["leaves"])
    bad_metrics = sorted(key for key, v in runs[False]["metrics"].items()
                         if not torch.equal(v, runs[True]["metrics"][key]))
    _restore(state, start)
    planted = {**batches[0], "image": batches[0]["image"].clone()}
    planted["image"][1, hw // 2, hw // 2] = float("nan")
    message = None
    t0 = time.perf_counter()
    try:
        check(state, planted, None, state.step)
    except FloatingPointError as e:
        message = str(e)
    locate_s = time.perf_counter() - t0
    after, _ = leaves_diff(start, _snapshot(state_leaves(state)))
    rec = {"batch": batch, "steps": steps, "leaves_differing": bad,
           "metrics_differing": bad_metrics,
           "plain_ms_per_step": runs[False]["ms"],
           "debug_nans_ms_per_step": runs[True]["ms"],
           "raised": message, "raise_s": locate_s,
           "state_changed_by_the_raise": after,
           "launches": [runs[False]["launches"], runs[True]["launches"]]}
    print("debug-nans " + json.dumps({k: v for k, v in rec.items()
                                       if k != "launches"}), flush=True)
    expect(not bad and not bad_metrics,
           f"debug_nans: clean steps differ from the plain ones in "
           f"{bad[:8]} (max {worst}) and metrics {bad_metrics}")
    expect(message is not None and "the output of module model." in message,
           f"debug_nans: a NaN input raised {message!r}")
    expect(not after, f"debug_nans: the raise left the state changed in "
                      f"{after[:8]}")
    return rec


def device_data_phase(seed, datasets, val, card, eager_dice, dev="cuda",
                      hw=HW, runs=CAPTURE_RUNS, dp_cells=DD_DP_CELLS,
                      widths=None, nan_batch=N, two_ranks=None):
    """Phase 11: device_data_run for the methods at their phase-3 cells
    (`runs`: CAPTURE_RUNS), the train command with --device_data 0
    --steps_per_call 4 (capture_cli: captured, phase 5's Dice bit for bit
    and its LEARN_RUNS bound), two gloo ranks with device_data 0 against
    the single process (phase 8's tolerances; on the card both on
    cuda:0), and debug_nans (debug_nans_part); the device_data line.
    The two ranks run host_fed(dp_cells); two_ranks: phase 8's
    {cell_key: record} where its group ran them (DD_HOST_CELLS), else
    this phase spawns its own group (dp_group). Its records are keyed by
    method."""
    import torch

    t0 = time.perf_counter()
    recs = []
    for method, model_name, batch, key in runs:
        data = datasets[key]
        recs.append(device_data_run(method, model_name, batch, data, seed,
                                    dev, hw, **gate_spec(method, batch,
                                                         len(data))))
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    runs_s = time.perf_counter() - t0
    cli_run = None
    if dev == "cuda":
        cli_run = capture_cli(seed, datasets["dense"], val, eager_dice, dev,
                              hw, extra=("--device_data", "0"),
                              name="device_data_cli")
        dice = cli_run["vals"][0][1]
        expect(dice >= LEARN_RUNS[0][4],
               f"--device_data 0: val Dice {dice} under {LEARN_RUNS[0][4]}")
    t1 = time.perf_counter()
    cells, dp_s = [host_fed(cell) for cell in dp_cells], None
    if two_ranks is None:
        outs = dp_group(2, cells, dev, os.path.join(
            ROOT, "build", "chip_smoke", "dd_two_ranks"),
            cards=[0, 0] if dev == "cuda" else None, hw=hw, seed=seed,
            widths=widths)
        two_ranks = dp_verdict(outs, cells, dev)
        dp_s = time.perf_counter() - t1
    two = {cell[0]: two_ranks[cell_key(cell)] for cell in cells}
    nans = debug_nans_part(seed, datasets["dense"], dev, hw, nan_batch)
    out = {"card": card, "runs": recs, "cli": cli_run, "two_ranks": two,
           "debug_nans": nans, "runs_s": runs_s, "two_ranks_s": dp_s,
           "phase_s": time.perf_counter() - t0}
    line = {"card": card, "phase_s": out["phase_s"], "k": DD_K,
            "runs": [{key: r.get(key) for key in (
                "method", "batch", "start", "leaves",
                "eager_leaves_differing", "eager_metrics_differing",
                "captured_leaves_differing", "captured_metrics_differing",
                "eager_ms_per_step", "captured_ms_per_step",
                "busy_share_eager", "busy_share_captured", "run_s")}
                for r in recs],
            "cli": cli_run and {key: cli_run[key] for key in (
                "extra", "steps", "vals", "eager_dice", "ms_per_step",
                "capture_s", "wall_s")},
            "two_ranks": {m: {key: r[key] for key in (
                "batch", "diff", "ms_per_step", "single_ms_per_step",
                "ranks_bit_equal")} for m, r in two.items()},
            "debug_nans": {key: nans[key] for key in (
                "leaves_differing", "metrics_differing", "plain_ms_per_step",
                "debug_nans_ms_per_step", "raised", "raise_s")},
            "runs_s": runs_s, "two_ranks_s": dp_s}
    print("device_data " + json.dumps(line), flush=True)
    return out


def dd_launch_records(dd):
    """Phase 11's launch counts as records: each method's host-fed eager
    steps, the train command's, the two-rank part's and debug_nans'."""
    recs = [{"launches": r["launches"]} for r in dd["runs"]]
    if dd["cli"] is not None:
        recs.append({"launches": dd["cli"]["launches"]})
    if dd["two_ranks_s"] is not None:  # else phase 8's records count them
        recs += [{"launches": d} for r in dd["two_ranks"].values()
                 for d in r["launches"]]
    return recs + [{"launches": d} for d in dd["debug_nans"]["launches"]]


# ---- main --------------------------------------------------------------------


CONV_KERNELS = ("conv3x3_fwd", "conv3x3_fwd_stats", "conv3x3_wgrad")
# the roles of a step's conv launches (conv_role) that each kernel serves
F32_ROLES = {"conv3x3_fwd": ("fwd", "dgrad"),
             "conv3x3_fwd_stats": ("fwd_stats",),
             "conv3x3_wgrad": ("wgrad",)}


def summarize(recs, launches, f32_launches):
    """Per-kernel JSON entries: times summed over one fully_supervised
    training step's shapes (bf16, batch 24, the timed records; for
    gated_crf one pce_gatedcrf step's launch, f32, batch 6; for
    augment_s2l one s2l step's launch, batch 12); max_abs_err over every
    check, in the path's dtype, of a launch on a training path (batches
    24, 12 and 6, the validation forward and the refresh's). The conv
    kernels' f32 instantiations get entries of their own (name + "_f32"):
    their times conv_step_sums' over the f32 launches of that step (the
    roles in F32_ROLES; the stats forward has no library call: cuDNN
    computes no moments), the launches of the f32 cell (f32_launches), and
    library_tf32_ms beside library_ms."""
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
        # no Pallas kernel: the JAX package leaves BN, LeakyReLU and the
        # dropout to XLA's fusion
        "bn_act_fwd": (SRC_BN, BN_REPLACES, "bfloat16"),
        "bn_act_sums": (SRC_BN, BN_REPLACES, "bfloat16"),
        "bn_act_bwd": (SRC_BN, BN_REPLACES, "bfloat16"),
    }
    entries = [(name, name, dtype, launches[name])
               for name, (_, _, dtype) in rows.items()]
    entries += [(f"{name}_f32", name, "float32", f32_launches[name])
                for name in CONV_KERNELS]
    f32 = conv_step_sums(recs, "float32")
    out = []
    for name, kernel, dtype, count in entries:
        source, replaces, _ = rows[kernel]
        path = [r for r in recs if r["kernel"] == kernel
                and r["dtype"] == dtype and _on_path(r)]
        mine = [r for r in path if "ms" in r]
        if name.endswith("_f32"):
            parts = [f32[role] for role in F32_ROLES[kernel] if role in f32]
            times = {k: _sum([p[k] for p in parts]) for k in (
                "ms", "plain_ms", "bound_ms", "library_ms",
                "library_tf32_ms")}
            if kernel == "conv3x3_fwd_stats":
                times.update(library_ms=None, library_tf32_ms=None)
        else:
            times = {k: _sum([r[k] for r in mine]) for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in path),
            "bound_by": _bound_by(mine), **times})
    return out


def _sum(values):
    """The sum of a list of times, None if one is missing."""
    return None if None in values else sum(values)


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


def conv_table(recs, dtype="bfloat16"):
    """Markdown rows, one per UNet conv, of the b24 step's conv launches in
    `dtype`: the forward (fwd_stats, fwd for the head), the dgrad and the
    wgrad, each as ms / bound ms / cuDNN ms (the forward's cuDNN is
    F.conv2d, which computes no moments; f32: cuDNN with TF32 off, then
    with TF32 on)."""
    keys = ["library_ms"] + (["library_tf32_ms"] if dtype == "float32"
                             else [])
    mine, lib_fwd = step_convs(recs, dtype)

    def cell(r, lib=None):
        if r is None:
            return "—"
        libs = [(lib or r)[k] for k in keys]
        return " / ".join([f"{r['ms']:.4f}", f"{r['bound_ms']:.4f}"] + [
            "—" if v is None else f"{v:.4f}" for v in libs])

    head = "cuDNN" if dtype == "bfloat16" else "cuDNN / cuDNN TF32"
    rows = [f"| conv | C→O | H | fwd(+stats) ms / bound / {head} | dgrad | "
            "wgrad |", "|---|---|---|---|---|---|"]
    for name, c, o, h in unet_convs():
        fwd = mine.get((name, "fwd_stats")) or mine.get((name, "fwd"))
        dg = mine.get((name, "dgrad"))
        rows.append(f"| {name} | {c}→{o} | {h} | {cell(fwd, lib_fwd.get(name))}"
                    f" | {cell(dg)} | {cell(mine.get((name, 'wgrad')))} |")
    return rows


def conv_role(r):
    """A conv kernel-check record's role: wgrad, dgrad, eval (the
    validation forward), fwd_stats, or fwd (the fwd kernel as a forward:
    the head's on the training path)."""
    if r["kernel"] == "conv3x3_wgrad":
        return "wgrad"
    return r.get("role") or ("fwd_stats" if r["kernel"]
                             == "conv3x3_fwd_stats" else "fwd")


def step_convs(recs, dtype):
    """The timed conv records of the b24 step in `dtype` (batch N, no
    case): ({(conv, role): record} of the training path's launches,
    {conv: record} of each conv's fwd-kernel forward, whose F.conv2d is
    the library call at that conv's forward shape)."""
    mine, fwd = {}, {}
    for r in recs:
        if not (r["kernel"].startswith("conv3x3") and r["dtype"] == dtype
                and "ms" in r and r.get("case") is None
                and r["shape"][0] == N):
            continue
        role = conv_role(r)
        if role == "fwd":
            fwd[r["conv"]] = r
        if _on_path(r):
            mine[(r["conv"], role)] = r
    return mine, fwd


def conv_step_sums(recs, dtype):
    """Sums over the b24 step's conv launches in `dtype` (step_convs), per
    role (fwd_stats, fwd: the head, dgrad, wgrad) and in all: launches,
    ms, plain_ms, bound_ms and the library times (f32: TF32 off and on;
    None where a launch has none); the stats forward's library times are
    F.conv2d's at its shape (cuDNN computes no moments)."""
    keys = ["ms", "plain_ms", "bound_ms", "library_ms"] + (
        ["library_tf32_ms"] if dtype == "float32" else [])
    mine, plain_fwd = step_convs(recs, dtype)
    out = {}
    for (conv, role), r in mine.items():
        lib = plain_fwd.get(conv, {}) if role == "fwd_stats" else r
        vals = {k: lib.get(k) if k.startswith("library") else r[k]
                for k in keys}
        for key in (role, "all"):
            s = out.setdefault(key, {"launches": 0, **{k: 0.0 for k in keys}})
            s["launches"] += 1
            for k in keys:
                s[k] = _sum([s[k], vals[k]])
    return out


def wrapper_calls():
    """(name, call, reps) of one call of each wrapper whose host time is
    recorded: the conv wrappers on a bf16 6x16x16x64 -> 64 conv and the
    pool wrappers on its input, too small for the device to be the limit;
    the augment wrapper at the fs24 step's
    batch, its S2L variant at the s2l step's and the GatedCRF contraction
    at the pce_gatedcrf step's, their path shapes (fewer calls, so that
    the launch queue never fills); the fused BN layer's three on the
    deepest level's bf16 6x16x16x64, with dropout."""
    import torch

    from wsl4mis_torch.data.augment_device import sample_policy
    from wsl4mis_torch.ops import augment as ag
    from wsl4mis_torch.ops import bn_act as ba
    from wsl4mis_torch.ops import conv3x3 as cv
    from wsl4mis_torch.ops import gated_crf as gc
    from wsl4mis_torch.ops import maxpool as mp

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((6, 16, 16, 64), generator=gen, device="cuda").bfloat16()
    g = torch.randn((6, 8, 8, 64), generator=gen, device="cuda").bfloat16()
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
    bn = bn_inputs(6, 16, 64, "bfloat16", 0.3)
    vec = (bn["scale"], bn["shift"], bn["mean"], bn["var"])
    _, mask, fac = ba.bn_act_fwd(bn["y"], (bn["s1"], bn["s2"]), *vec,
                                 bn["u"], n=bn["n"], keep=bn["keep"])
    sums = ba.bn_act_sums(bn["g"], bn["y"], mask, fac, bn["scale"],
                          n=bn["n"], keep=bn["keep"])
    return [
        ("conv3x3_fwd", lambda: cv.conv3x3_fwd(x, w, b), 300),
        ("conv3x3_fwd_stats", lambda: cv.conv3x3_fwd_stats(x, w, b), 300),
        ("conv3x3_wgrad", lambda: cv.conv3x3_wgrad(x, x), 300),
        ("maxpool_fwd", lambda: mp.max_pool_2x2_fwd(x), 300),
        ("maxpool_bwd", lambda: mp.max_pool_2x2_bwd(x, g), 300),
        ("augment", lambda: ag.augment_batch(images, labels, policy), 100),
        ("augment_s2l", lambda: ag.augment_batch_s2l(*s2l_maps, s2l_policy),
         100),
        ("gated_crf", lambda: gc.gated_crf_products(
            probs, planes, GCRF_RADIUS, weights, nf, xy), 100),
        ("bn_act_fwd", lambda: ba.bn_act_fwd(
            bn["y"], (bn["s1"], bn["s2"]), *vec, bn["u"], n=bn["n"],
            keep=bn["keep"], update=True), 300),
        ("bn_act_sums", lambda: ba.bn_act_sums(
            bn["g"], bn["y"], mask, fac, bn["scale"], n=bn["n"],
            keep=bn["keep"]), 300),
        ("bn_act_bwd", lambda: ba.bn_act_bwd(
            bn["g"], bn["y"], mask, fac, sums[2], sums[3], keep=bn["keep"]),
         300),
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


def check_sync_free(calls, names=("conv3x3_fwd", "conv3x3_fwd_stats",
                                  "conv3x3_wgrad", "maxpool_fwd",
                                  "maxpool_bwd", "augment", "augment_s2l",
                                  "gated_crf", "bn_act_fwd", "bn_act_sums",
                                  "bn_act_bwd")):
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


def f32_conv_sass(sass):
    """The f32 conv kernels' entries of conv_sass_report."""
    return {fn: k for fn, k in sass.items()
            if re.search(r"conv3x3_(?:fwd|wgrad)_kernel\b", fn)}


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
    # the f32 kernels, as many, compute in exact f32: no tensor-core op
    f32 = f32_conv_sass(sass)
    expect(len(f32) == 11 and not any(f32.values()),
           f"sass: the f32 conv kernels hold tensor-core ops: {f32}")

    recs = []
    for dtype in ("bfloat16", "float32"):
        for name, c, o, h in unet_convs():
            recs += check_conv(name, c, o, h, dtype, N, timed=True,
                               repeat=True)
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
        seen = set()
        for name, c, h, drop in unet_bn_layers():
            recs += check_bn_act(name, c, h, drop, dtype, N, timed=True,
                                 repeat=True)
            if (c, h, drop) in seen:
                continue
            seen.add((c, h, drop))
            for n in (MS_N, DMPLS_N):
                recs += check_bn_act(name, c, h, drop, dtype, n,
                                     timed=False)
            for n in (EVAL_N, REFRESH_N):
                recs += check_bn_act(name, c, h, drop, dtype, n,
                                     timed=False, eval_only=True)
    calls = wrapper_calls()
    host_us = wrapper_host_us(calls)
    print("wrapper-host-us " + json.dumps(host_us), flush=True)
    sync_free = check_sync_free(calls)
    recs += check_augment(args.seed, N, timed=True)
    recs += check_augment(args.seed + 1, DMPLS_N, timed=False,
                          paths=("dmpls", "pce_gatedcrf", "scribblevc"))
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
                            args.seed, "path",
                            paths=("pce_gatedcrf", "scribblevc"))
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
    # slice 5: ScribbleVC at full width, the memory gate opening at step 5
    svc_data = synthetic_slices(SVC_SLICES, (HW, HW), seed=args.seed + 2,
                                sup_type="scribble")
    runs.append(run_method("scribblevc", "scribblevc", SVC_N, SVC_STEPS,
                           True, svc_data, val, args.seed))
    for method in ("mean_teacher", "entropy_minimization",
                   "partially_supervised", "deep_adversarial"):
        runs.append(run_method(method, "unet", SEMI_N, 3, False,
                               (labeled, unlabeled), val, args.seed,
                               time_steps=0))
    fs = runs[0]["losses"]
    expect(np.mean(fs[-5:]) < np.mean(fs[:5]),
           f"fully_supervised loss did not fall: {fs}")
    f32_sums = conv_step_sums(recs, "float32")
    f32 = f32_cell(args.seed, data, card, f32_sums["all"]["bound_ms"])
    phase_s["training"] = time.perf_counter() - t0 - sum(phase_s.values())
    ref = reference_check(args.seed)
    svc_ref = svc_reference_check(args.seed)
    phase_s["reference"] = time.perf_counter() - t0 - sum(phase_s.values())
    # last: the train command sets cuDNN deterministic (--deterministic 1)
    entry = entry_points(args.seed, data, scribbles, val, card)
    phase_s["entry"] = time.perf_counter() - t0 - sum(phase_s.values())
    svc_run = next(r for r in runs if r["method"] == "scribblevc")
    zoo = zoo_phase(args.seed, data, scribbles, val, card,
                    entry["runs"][0]["inference"]["path"], svc_run)
    phase_s["zoo"] = time.perf_counter() - t0 - sum(phase_s.values())
    resume = resume_phase(args.seed, data, scribbles, val, labeled,
                          unlabeled, svc_data, card)
    phase_s["resume"] = time.perf_counter() - t0 - sum(phase_s.values())
    # phases 1-7 run with no process group: no collective at all
    from wsl4mis_torch import parallel

    expect(not parallel.active() and not any(parallel.calls.values()),
           f"collectives before the data-parallel phase: {parallel.calls}")
    print("collectives in phases 1-7: 0", flush=True)
    dp = dp_phase(args.seed, card, host_cells=DD_HOST_CELLS)
    phase_s["data_parallel"] = (time.perf_counter() - t0
                                - sum(phase_s.values()))
    surface = surface_phase(args.seed, val, card,
                            entry["runs"][0]["inference"]["path"], svc_run)
    phase_s["surface"] = time.perf_counter() - t0 - sum(phase_s.values())
    datasets = {"dense": data, "scribble": scribbles,
                "random_walker": ArraySliceDataset(
                    scribbles.images[:RW_SLICES], rw_labels),
                "semi": (labeled, unlabeled), "svc": svc_data}
    captured = capture_phase(args.seed, datasets, val, card,
                             entry["runs"][0]["val_dice"][-1])
    phase_s["captured"] = time.perf_counter() - t0 - sum(phase_s.values())
    device_data = device_data_phase(
        args.seed, datasets, val, card, entry["runs"][0]["val_dice"][-1],
        two_ranks=dp["two_ranks_gloo"])
    phase_s["device_data"] = (time.perf_counter() - t0
                              - sum(phase_s.values()))
    print("phase-s " + json.dumps(phase_s), flush=True)

    counted = runs + [f32] + entry["runs"] + [entry["host_aug"]] + [
        r["inference"] for r in entry["runs"]] + zoo["train"] + zoo[
        "inference"] + [r for r in zoo["models"] if "launches" in r] + (
        resume["runs"] + [resume["cli"]]) + dp_launch_records(dp) + (
        surface_launch_records(surface)) + captured["runs"] + [
        {"launches": c["launches"]} for c in captured["remat"]["cells"]
        if "launches" in c] + [r for r in captured["remat"]["cli"][
            "runs"].values()] + [captured["cli"]] + dd_launch_records(
                device_data)
    launches = {k: sum(r["launches"].get(k, 0) for r in counted)
                for k in runs[0]["launches"]}
    idle = sorted(k for k, v in launches.items() if v == 0)
    expect(not idle, f"kernels never launched on a training path: {idle}")
    kernels = summarize(recs, launches, f32["launches"])
    table = conv_table(recs)
    for row in table:
        print(f"conv-table {row}", flush=True)
    table_f32 = conv_table(recs, "float32")
    for row in table_f32:
        print(f"conv-table-f32 {row}", flush=True)
    print("conv-f32-step " + json.dumps(f32_sums), flush=True)
    detail = {"card": card, "torch": torch.__version__,
              "build_s": build_s, "phase_s": phase_s, "ptxas": ptxas,
              "sass_mma": sass,
              "wrapper_host_us": host_us, "sync_free": sync_free,
              "conv_table": table, "conv_table_f32": table_f32,
              "conv_f32_step": f32_sums, "f32_cell": f32, "checks": recs,
              "runs": runs, "entry": entry, "zoo": zoo, "resume": resume,
              "data_parallel": dp, "surface": surface, "captured": captured,
              "device_data": device_data,
              "reference": ref, "svc_reference": svc_ref,
              "kernels": kernels}
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
