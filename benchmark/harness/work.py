"""The yardstick: the card's published peaks, the bound of a launch, and
the arithmetic of a 3x3 conv, which a configuration's module
(``configs/<name>.py``) uses to count its model's work from its shapes.

A configuration's module exports, for one slice at its patch size:

* ``forward_flops(config)``: operations of the forward;
* ``backward_flops(config)``: operations of the input and weight
  gradients, with no recomputation;
* ``conv_launches(config, batch, dtype, train)``: (name, role, bytes,
  operations) of the 3x3 convs of one forward (and, in training, its
  backward) of `batch` slices.

A method's reference file (``reference/methods/<m>.py``) turns these into
a training step's work (``work(net, config, batch, dtype)``): how many
forwards with and without a backward a step runs. The drivers read only
these functions, never a configuration's keys.

Counts are of the model's arithmetic, not of the port's launches, so they
read the same whatever kernels implement it. A 3x3 SAME conv of C to O
channels on an H x W plane: 2*9*C*O*H*W operations a slice; a 2x2
stride-2 transposed conv of C to O channels from an h x w plane:
2*C*4*O*h*w.

Bytes of a 3x3 conv launch (after ``chip_smoke.py``'s counts, which the
port's kernel table uses): each input read once and each output written
once; the forward reads x, w and b and writes y (and, in training, the
f32 BN moments, 2*O*4 bytes); the input gradient reads g and w and writes
dx; the weight gradient reads x and g and writes the f32 dK.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense rates without sparsity; f32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def conv_flops(c: int, o: int, h: int, w: int) -> float:
    """Operations of a 3x3 conv of one slice."""
    return 2.0 * 9 * c * o * h * w


def tconv_flops(c: int, o: int, h: int, w: int) -> float:
    """Operations of a 2x2 stride-2 transposed conv of one slice from an
    h x w plane."""
    return 2.0 * c * 4 * o * h * w


def conv3x3_launches(convs, batch: int, dtype: str,
                     train: bool) -> list[tuple]:
    """(name, role, bytes, operations) of the 3x3 convs `convs` [(name, C,
    O, H, W, stats, takes_dgrad)] over `batch` slices: `stats` where a
    train-mode BN follows (the forward writes its moments), `takes_dgrad`
    where the input takes a gradient."""
    es = ELEMENT_BYTES[dtype]
    out = []
    for name, c, o, h, w, stats, dgrad in convs:
        px = batch * h * w
        ops = batch * conv_flops(c, o, h, w)
        fwd = (px * c + 9 * c * o + o + px * o) * es
        if not train:
            out.append((name, "fwd", fwd, ops))
            continue
        out.append((name, "fwd_stats", fwd + 2 * o * 4, ops) if stats
                   else (name, "fwd", fwd, ops))
        if dgrad:
            out.append((name, "dgrad", (px * o + 9 * c * o + px * c) * es,
                        ops))
        out.append((name, "wgrad", (px * c + px * o) * es + 9 * c * o * 4,
                    ops))
    return out


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time: bytes at the memory rate or operations at the
    type's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def launches_bound_s(launches, dtype: str) -> float:
    """The bound of `launches` [(name, role, bytes, operations)], summed
    launch by launch."""
    return sum(bound_s(nb, ops, dtype) for _, _, nb, ops in launches)


def unet_convs(config: dict, decoders: int) -> list[tuple]:
    """(name, C, O, H, W, stats, takes_dgrad) of every 3x3 conv of a
    WSL4MIS U-Net with `decoders` decoders at its patch size: the
    encoder's, then each decoder's with its head last (no BN after it)."""
    f = config["feature_chns"]
    h, w = config["patch_size"]
    out = []
    cin = config["in_chns"]
    for i, c in enumerate(f):
        s = 2 ** i
        out += [(f"enc{i}.conv1", cin, c, h // s, w // s, True, i > 0),
                (f"enc{i}.conv2", c, c, h // s, w // s, True, True)]
        cin = c
    for d in range(decoders):
        for i in range(len(f) - 2, -1, -1):
            s = 2 ** i
            out += [(f"dec{d}.up{i}.conv1", 2 * f[i], f[i], h // s, w // s,
                     True, True),
                    (f"dec{d}.up{i}.conv2", f[i], f[i], h // s, w // s,
                     True, True)]
        out.append((f"dec{d}.head", f[0], config["class_num"], h, w, False,
                    True))
    return out


def unet_tconvs(config: dict, decoders: int) -> list[tuple]:
    """(name, C, O, h, w) of every 2x2 transposed conv: its input plane."""
    f = config["feature_chns"]
    h, w = config["patch_size"]
    out = []
    for d in range(decoders):
        for i in range(len(f) - 2, -1, -1):
            s = 2 ** (i + 1)
            out.append((f"dec{d}.up{i}.tconv", f[i + 1], f[i], h // s,
                        w // s))
    return out


def unet_forward_flops(config: dict, decoders: int) -> float:
    """Operations of one slice's forward through a U-Net."""
    return (sum(conv_flops(c, o, h, w)
                for _, c, o, h, w, _, _ in unet_convs(config, decoders))
            + sum(tconv_flops(c, o, h, w)
                  for _, c, o, h, w in unet_tconvs(config, decoders)))


def unet_backward_flops(config: dict, decoders: int) -> float:
    """Operations of one slice's input and weight gradients: twice the
    forward's, less the input gradient of the stem (the image takes
    none)."""
    stem = unet_convs(config, decoders)[0]
    return (2.0 * unet_forward_flops(config, decoders)
            - conv_flops(*stem[1:5]))
