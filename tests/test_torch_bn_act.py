"""The U-Net ConvBlock's fused conv -> BN -> LeakyReLU (-> dropout) layer
(wsl4mis_torch/ops/bn_act.py).

* On the CPU a ConvBlock runs the fused layer's plain versions, the
  arithmetic of the card's kernels. Against a copy of the eager chain it
  ran before the kernels came: its output and running statistics equal bit
  for bit; the gradients of its input, conv kernels and biases and BN
  scales and biases equal to rounding (the fused backward sums in f32
  where the chain's autograd rounds its per-channel sums to bf16): f32
  within 1e-5 of the largest value, bf16 within 2e-2 in norm, the same
  reading as the conv tests'. In bf16 and f32, with and without dropout,
  train and eval mode (a backward through the running statistics), with
  the statistics updated, not updated (an EMA teacher's) and frozen.
* The layer's autograd Function on the CPU against the chain's layer, and
  every ConvBlock layer taking it, with and without autograd.
* chip_smoke's check of the kernels against their plain versions, run on
  the CPU at small shapes (the plain versions stand in for the kernels):
  the forward bit-equal, the eval backward's cotangent bit-equal, the train
  backward's cotangent within its bound of the f64 version and no farther
  from it than the chain's.
* On a card (marked ``card``; skips without one): the kernels against
  their plain versions at every BN layer's shape of the pce batch-24 and
  dmpls batch-6 steps, and the f32 cell's; a ConvBlock on the card against
  the same block on the CPU, train and eval mode.

Inputs come from fixed seeds. This file imports no JAX."""

import copy

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import chip_smoke  # noqa: E402
from wsl4mis_torch.models.norm import statistics_frozen  # noqa: E402
from wsl4mis_torch.models.unet import ConvBlock  # noqa: E402
from wsl4mis_torch.ops import bn_act  # noqa: E402
from wsl4mis_torch.ops.conv3x3 import conv3x3, conv3x3_stats  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---- the eager chain, as ConvBlock ran it before the fused kernels --------


def _chain_layer(conv, bn, x, train):
    x = x.to(conv.dtype).contiguous()
    k, b = conv.kernel.to(conv.dtype), conv.bias.to(conv.dtype)
    if train:
        y, s1, s2 = conv3x3_stats(x, k, b)
        y = bn(y, train=True, moments=(s1, s2))
    else:
        y = bn(conv3x3(x, k, b), train=False)
    return F.leaky_relu(y, 0.01)


def _chain_block(block, x, train, generator):
    x = _chain_layer(block.conv1, block.bn1, x, train)
    if block.dropout_p > 0 and train:
        keep = 1.0 - block.dropout_p
        mask = torch.rand(x.shape, generator=generator) < keep
        x = x * (mask.to(block.dtype) * (1.0 / keep))
    return _chain_layer(block.conv2, block.bn2, x, train)


def _block(dtype, dropout, seed=0):
    gen = torch.Generator().manual_seed(seed)
    block = ConvBlock(3, 8, dropout, DTYPES[dtype], gen)
    for bn in (block.bn1, block.bn2):  # statistics and affine away from 0/1
        with torch.no_grad():
            bn.scale.copy_(1 + 0.3 * torch.randn(8, generator=gen))
            bn.bias.copy_(0.2 * torch.randn(8, generator=gen))
            bn.mean.copy_(0.1 * torch.randn(8, generator=gen))
            bn.var.copy_(1 + 0.2 * torch.rand(8, generator=gen))
    return block


def _run(fn, block, x, g, stats):
    """(output, {name: grad}, {name: buffer}) of fn(block, x) with the
    statistics mode `stats`: "update", "no_update" (update_stats False) or
    "frozen" (statistics_frozen)."""
    x = x.clone().requires_grad_()
    if stats == "no_update":
        block.bn1.update_stats = block.bn2.update_stats = False
    with statistics_frozen() if stats == "frozen" else _nothing():
        out = fn(block, x)
    out.backward(g)
    grads = {"x": x.grad, **{n: p.grad for n, p in block.named_parameters()}}
    return out, grads, dict(block.named_buffers())


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _bit_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


def _close_grads(grads, want_grads, dtype, train):
    """Gradients to rounding: f32 within 1e-5 of the largest value (a bias
    gradient that train mode's BN makes ~0 against the input gradient's
    scale), bf16 within 2e-2 in norm (such a bias's skipped: rounding)."""
    assert grads.keys() == want_grads.keys()
    for name, got in grads.items():
        ref = want_grads[name]
        if got is None or ref is None:
            assert got is None and ref is None, name
            continue
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        got, ref = got.float(), ref.float()
        zero_mean = train and name.endswith(".bias") and "conv" in name
        if dtype == "float32":
            scale = want_grads["x"].abs().max() if zero_mean else (
                ref.abs().max())
            assert float((got - ref).abs().max()) <= 1e-5 * float(scale), \
                name
        elif not zero_mean:
            assert float((got - ref).norm() / ref.norm()) <= 2e-2, name


@pytest.mark.parametrize("stats", ["update", "no_update", "frozen"])
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_block_on_the_cpu_is_the_eager_chain(dtype, dropout, mode, stats):
    """The fused path against the eager chain: the forward and the running
    statistics bit-equal, the gradients to rounding."""
    train = mode == "train"
    block = _block(dtype, dropout)
    chain = copy.deepcopy(block)
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    g = torch.randn((2, 8, 8, 8), generator=torch.Generator().manual_seed(2)
                    ).to(DTYPES[dtype])

    def new(m, xi):
        return m(xi, train, torch.Generator().manual_seed(3))

    def old(m, xi):
        return _chain_block(m, xi, train, torch.Generator().manual_seed(3))

    calls = dict(bn_act.launches)
    out, grads, bufs = _run(new, block, x, g, stats)
    want, want_grads, want_bufs = _run(old, chain, x, g, stats)
    assert bn_act.launches == calls  # the CPU launches no kernel
    _bit_equal(out, want)
    _close_grads(grads, want_grads, dtype, train)
    for name in bufs:
        _bit_equal(bufs[name], want_bufs[name])
    moved = not torch.equal(bufs["bn1.mean"], _block(dtype, dropout).bn1.mean)
    assert moved == (train and stats == "update")


def _layer_inputs(dtype, seed=4):
    gen = torch.Generator().manual_seed(seed)
    block = _block(dtype, 0.3, seed)
    x = torch.randn((3, 8, 8, 3), generator=gen)
    u = torch.rand((3, 8, 8, 8), generator=gen)
    g = torch.randn((3, 8, 8, 8), generator=gen).to(DTYPES[dtype])
    return block, x, u, g


@pytest.mark.parametrize("stats", ["update", "no_update", "frozen"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_function_on_the_cpu(dtype, dropout, stats):
    """bn_act.conv_bn_act on the CPU (the plain versions) against the
    chain's layer: forward and statistics bit-equal, gradients to
    rounding."""
    block, x, u, g = _layer_inputs(dtype)
    keep = 1.0 - dropout
    drawn = u if dropout else None

    def fused(m, xi):
        return bn_act.conv_bn_act(*m.conv1.operands(xi), m.bn1, True, drawn,
                                  keep)

    def chain(m, xi):
        y = _chain_layer(m.conv1, m.bn1, xi, True)
        if dropout:
            y = y * ((u < keep).to(m.dtype) * (1.0 / keep))
        return y

    calls = dict(bn_act.launches)
    twin = copy.deepcopy(block)
    out, grads, bufs = _run(fused, block, x, g, stats)
    want, want_grads, want_bufs = _run(chain, twin, x, g, stats)
    assert bn_act.launches == calls  # the CPU launches no kernel
    _bit_equal(out, want)
    for name in ("bn1.mean", "bn1.var"):
        _bit_equal(bufs[name], want_bufs[name])
    for name in ("x", "conv1.kernel", "conv1.bias", "bn1.scale", "bn1.bias"):
        got, ref = grads[name].float(), want_grads[name].float()
        if dtype == "float32":
            scale = ref.abs().max() if name != "conv1.bias" else (
                want_grads["x"].abs().max())  # the bias's is ~0: rounding
            assert float((got - ref).abs().max()) <= 1e-5 * float(scale)
        elif name != "conv1.bias":
            assert float((got - ref).norm() / ref.norm()) <= 2e-2, name
    assert grads["conv2.kernel"] is None  # the layer runs conv1 alone


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_eval_forward_without_autograd_is_the_chain(dtype):
    block, x, _, _ = _layer_inputs(dtype)
    with torch.no_grad():
        got = bn_act.conv_bn_act(*block.conv1.operands(x), block.bn1, False)
        want = _chain_layer(block.conv1, block.bn1, x, False)
    _bit_equal(got, want)


@pytest.mark.parametrize("mode", ["train", "eval", "eval_no_grad"])
def test_every_block_layer_takes_the_fused_layer(monkeypatch, mode):
    """Both layers of a ConvBlock go through conv_bn_act, in train mode,
    in eval mode and without autograd; no BN module is called."""
    from wsl4mis_torch.models import unet

    seen = []
    real = bn_act.conv_bn_act

    def counted(x, w, b, bn, train, u=None, keep=1.0):
        seen.append((bn, train, u is not None))
        return real(x, w, b, bn, train, u, keep)

    monkeypatch.setattr(unet.bn_act, "conv_bn_act", counted)
    block = _block("float32", 0.3)
    for bn in (block.bn1, block.bn2):
        monkeypatch.setattr(bn, "forward", None)  # calling it would raise
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    train = mode == "train"
    with torch.no_grad() if mode == "eval_no_grad" else _nothing():
        block(x, train, torch.Generator().manual_seed(3))
    assert seen == [(block.bn1, train, train), (block.bn2, train, False)]


def test_eval_mode_without_autograd_saves_nothing():
    """Eval mode without autograd makes no saved values (the validation's
    forward); with autograd it keeps what its backward reads."""
    block, x, _, _ = _layer_inputs("float32")
    y = torch.randn((3, 8, 8, 8), generator=torch.Generator().manual_seed(5))
    vec = (block.bn1.scale.detach(), block.bn1.bias.detach(),
           block.bn1.mean, block.bn1.var)
    assert bn_act.bn_act_fwd(y, None, *vec, factors=False)[2] is None
    fac = bn_act.bn_act_fwd(y, None, *vec)[2]
    r = torch.rsqrt(block.bn1.var + 1e-5)
    assert torch.equal(fac[0], block.bn1.mean)
    assert torch.equal(fac[1], block.bn1.var) and torch.equal(fac[2], r)
    moments = (y.sum((0, 1, 2)), (y * y).sum((0, 1, 2)))
    assert bn_act.bn_act_fwd(y, moments, *vec, n=192,
                             factors=False)[2].shape == (5, 8)


def test_wrappers_take_the_plain_version_on_cpu_and_check_cuda_operands():
    with pytest.raises(RuntimeError, match="no bn_act implementation"):
        bn_act.bn_act_fwd(torch.zeros(1, 8, device="meta"), None,
                          *[torch.zeros(8, device="meta")] * 4)
    y = torch.zeros(2, 4, 4, 600)
    with pytest.raises(ValueError, match="600 channels"):
        bn_act._check("bn_act_fwd", y)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bn_act._check("bn_act_fwd", torch.zeros(257)[1:].view(2, 4, 4, 8))
    # a backward pass's fac must carry the tickets bn_act_fwd puts after it
    with pytest.raises(ValueError, match="tickets"):
        bn_act._check_fac("bn_act_sums", torch.zeros(5, 8), 8)
    bn_act._check_fac("bn_act_sums", torch.zeros(42)[:40].view(5, 8), 8)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c,h,n", [(16, 16, 3), (32, 4, 6), (8, 8, 2)])
def test_kernel_check_runs_on_the_cpu(c, h, n, dtype, dropout):
    recs = chip_smoke.check_bn_act("cpu", c, h, dropout, dtype, n,
                                   timed=False, dev="cpu", repeat=True)
    assert [(r["kernel"], r["role"]) for r in recs] == [
        (k, role) for role in ("eval", "train")
        for k in ("bn_act_fwd", "bn_act_sums", "bn_act_bwd")]
    assert all(r["ok"] for r in recs)
    bwd = recs[-1]
    if dtype == "bfloat16":  # the f32 sums beat the chain's bf16 ones
        assert bwd["err"] <= 0.5 + 1e-3 < bwd["err_eager"]


def test_bn_layers_are_the_unets():
    """unet_bn_layers lists a full-width UNet's BN layers: their channels
    and sizes as a 32x32 forward scales to 256x256, dropout on the
    encoder's first layer of each level."""
    from wsl4mis_torch.models import net_factory

    model = net_factory("unet", 4, dtype=torch.float32)
    shapes = []

    def hook(mod, args, out):
        shapes.append((out.shape[-1], out.shape[1]))

    def block_hook(mod, args, out):  # a ConvBlock: two BN layers alike
        hook(mod, args, out)
        hook(mod, args, out)

    handles = [m.register_forward_hook(block_hook) for m in model.modules()
               if isinstance(m, ConvBlock)]
    with torch.no_grad():
        model(torch.zeros((1, 32, 32, 1)), train=False)
    for hd in handles:
        hd.remove()
    scale = chip_smoke.HW // 32
    layers = chip_smoke.unet_bn_layers()
    assert len(layers) == len(shapes) == 18
    assert [(c, h * scale) for c, h in shapes] == [
        (c, h) for _, c, h, _ in layers]
    assert [p for _, _, _, p in layers[0:10:2]] == list(
        chip_smoke.UNET_DROPOUT)


def _layer_grads(block, x, u, g):
    """conv_bn_act (train, dropout 0.3) on the CPU: the output, the
    gradients of x, the conv kernel and bias and the BN scale and bias, and
    the running statistics after."""
    x = x.clone().requires_grad_()
    out = bn_act.conv_bn_act(*block.conv1.operands(x), block.bn1, True, u,
                             0.7)
    out.backward(g)
    return {"out": out.detach(), "x": x.grad,
            "kernel": block.conv1.kernel.grad,
            "bias": block.conv1.bias.grad, "scale": block.bn1.scale.grad,
            "shift": block.bn1.bias.grad, "mean": block.bn1.mean.clone(),
            "var": block.bn1.var.clone()}


def test_fused_function_under_a_process_group(tmp_path):
    """Two gloo ranks, each on half the batch (rows 0-1 and 2-3), against
    one process on the whole batch (f32): the same output rows, running
    statistics and input gradient rows, and parameter gradients that sum
    to the whole batch's, to f32 summation order (1e-5 of the largest)."""
    from wsl4mis_torch import parallel

    block, x, u, g = _layer_inputs("float32")
    x, u, g = (torch.cat([t, t.flip(0)]) for t in (x, u, g))  # 6 rows
    want = _layer_grads(block, x, u, g)
    parallel.spawn(_group_rank_rows, 2, "cpu", args=(str(tmp_path),),
                   init_method="file://" + str(tmp_path / "rendezvous"))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]

    def close(got, ref):
        assert got.shape == ref.shape
        tol = 1e-5 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol

    for key in ("out", "x"):
        close(torch.cat([r[key] for r in ranks]), want[key])
    for key in ("mean", "var"):
        for r in ranks:
            close(r[key], want[key])
    for key in ("kernel", "scale", "shift"):
        close(ranks[0][key] + ranks[1][key], want[key])


def _group_rank_rows(rank, out_dir):
    import os

    from wsl4mis_torch import parallel

    block, x, u, g = _layer_inputs("float32")
    x, u, g = (parallel.local_rows(torch.cat([t, t.flip(0)]))
               for t in (x, u, g))
    torch.save(_layer_grads(block, x, u, g),
               os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("dtype,n", [("bfloat16", chip_smoke.N),
                                     ("bfloat16", chip_smoke.DMPLS_N),
                                     ("float32", chip_smoke.N)])
def test_kernels_match_plain_at_the_cells_shapes(card, dtype, n):
    """Every BN layer's shape of the pce b24, dmpls b6 and f32 b24 steps:
    chip_smoke.check_bn_act raises on a fault."""
    seen = set()
    for name, c, h, drop in chip_smoke.unet_bn_layers():
        if (c, h, drop) in seen:
            continue
        seen.add((c, h, drop))
        recs = chip_smoke.check_bn_act(name, c, h, drop, dtype, n,
                                       timed=False, dev=card, repeat=True)
        assert all(r["ok"] for r in recs)


@pytest.mark.card
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_block_on_the_card_is_the_cpus(card, mode):
    """A ConvBlock (f32, dropout 0.3) on the card against the same block on
    the CPU, the same draw: the output, the gradients and the running
    statistics within 1e-4 of the largest value (the conv's sums in
    another order; a ~0 conv bias gradient against the input's)."""
    train = mode == "train"
    block = _block("float32", 0.3)
    on_card = copy.deepcopy(block).to(card)
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    g = torch.randn((4, 32, 32, 8), generator=torch.Generator().manual_seed(2))
    out, grads, bufs = _run(
        lambda m, xi: m(xi, train, torch.Generator().manual_seed(3)),
        block, x, g, "update")

    def card_block(m, xi):  # the CPU's draw, handed to the card's layer
        u = torch.rand((4, 32, 32, 8), generator=torch.Generator(
            ).manual_seed(3)).to(card) if train else None
        xi = bn_act.conv_bn_act(*m.conv1.operands(xi), m.bn1, train, u, 0.7)
        return bn_act.conv_bn_act(*m.conv2.operands(xi), m.bn2, train)

    got, got_grads, got_bufs = _run(card_block, on_card, x.to(card),
                                    g.to(card), "update")

    def close(a, b, scale=None):
        scale = b.abs().max() if scale is None else scale
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(scale)

    close(got, out)
    for name, ref in grads.items():
        zero_mean = train and name.endswith(".bias") and "conv" in name
        close(got_grads[name], ref, grads["x"].abs().max() if zero_mean
              else None)
    for name, ref in bufs.items():
        close(got_bufs[name], ref)
