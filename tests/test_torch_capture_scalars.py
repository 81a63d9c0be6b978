"""No host value is frozen into a captured step: the CPU's proxy for the
CUDA graph capture of ``engine.graph`` (on the card chip_smoke's phase 10
holds the captured calls to the eager steps).

A capture records the step's kernels with every host value they take as
it stands at the capture, and replays them at later steps. So a step must
read every per-step value from the device (``TrainState.step_tensor``,
the ``step_scalar`` buffers, the optimizer's) or take it as a keyword
argument that names its variant (``MethodBundle.variant``, one graph a
value). Here ``capturing()`` is made to answer True in every module of the
port that asks it, so the step fills none of its device scalars, and the
state's host counts (``TrainState.host_counts``: the step, the optimizer's
count, DAN's Adam count) are frozen at 0, while the device scalars
(``load_step_scalars``) and the variant are loaded for step n, as the
graph loads them before a replay. The step must then equal the eager step
at n, every leaf and metric bit for bit, and advance each host count by
one.

n lies past every ramp's knee and gate: the ramps of step // 150, // 300
and // 1000 and uamt's threshold move between 0 and n, the EMA decay is
alpha at n and 0 at step 0, DAN's and AdamW's bias corrections and the
poly LR differ; s2l's gate (thr_iter 1000, its pseudo-label term live)
and scribblevc's (2 steps an epoch) are taken on both sides, and ustm at
each of its four rotations.

Also, at each of 16 steps, the host's variant pick equals the eager
step's own decision (ustm's rotation read from its first rot90 call, s2l's
gate from whether the pseudo-label term's input carries a gradient,
scribblevc's from the forward's use_class_rep; the step stops there), all
four rotations among ustm's and both sides of each gate.

Narrow models (UNet features 4..16 at 32x32, ScribbleVC base 8, embed 32,
2 heads at 64x64), batch 4, f32, one torch thread.
"""

import copy
import functools
import sys

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import wsl4mis_torch.utils.device as tdevice  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import available_methods  # noqa: E402
from wsl4mis_torch.engine.methods import s2l as ts2l  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402

HW, SVC_HW, B, SEED = 32, 64, 4, 3
FEATURES = (4, 8, 8, 16, 16)
SVC_WIDTHS = dict(base_channel=8, embed_dim=32, num_heads=2)
N = 1234  # past every ramp's knee, s2l's and scribblevc's gates
THR_ITER = 1000  # s2l's gate
PICK_STEPS = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def narrow(monkeypatch):
    from wsl4mis_torch.engine.methods import common
    from wsl4mis_torch.engine.methods import scribblevc as msvc

    monkeypatch.setattr(common, "net_factory", functools.partial(
        net_factory, features=FEATURES))
    monkeypatch.setattr(msvc, "net_factory", functools.partial(
        net_factory, **SVC_WIDTHS))


def _capturing(monkeypatch):
    """capturing() answers True in every module of the port that imports
    it."""
    capturing = tdevice.capturing
    patched = [mod for name, mod in list(sys.modules.items())
               if name.startswith("wsl4mis_torch")
               and getattr(mod, "capturing", None) is capturing]
    assert len(patched) >= 4  # utils.device, optim, state, methods.common
    for mod in patched:
        monkeypatch.setattr(mod, "capturing", lambda: True)


def _bundle(method):
    """(cfg, bundle, one batch) of the method on its phantoms; s2l's buffer
    refreshed once, with thr_conf 0.04 under every pixel's largest buffer
    value after one refresh (alpha * max_c p_c >= 0.2 / 4), so that its
    pseudo-label term is live."""
    method, model, batch, kind = chip_smoke.dp_cell(method, B)
    hw = SVC_HW if method == "scribblevc" else HW
    cfg = TrainConfig(
        method=method, model=model, batch_size=batch, labeled_bs=batch // 2,
        max_iterations=10 ** 4, compute_dtype="float32", seed=SEED,
        device="cpu", patch_size=(hw, hw), thr_iter=THR_ITER,
        thr_conf=0.04, sup_type=chip_smoke.sup_type_of(method))
    data = chip_smoke.dp_data(kind, hw, SEED)
    bundle, batches = chip_smoke.method_bundle(cfg, data, None)
    if method == "s2l":
        bundle.host_hook(bundle, bundle.state, cfg.period_iter)
    return cfg, bundle, next(batches())


def _metrics(m):
    return chip_smoke._metrics_leaves(m)


def _step_at(bundle, batch, n, proxy, monkeypatch):
    """The state's leaves and the metrics after its step at n, from host
    counts n: eager, or (proxy) with the counts frozen at 0, the device
    scalars and the variant loaded for n, capturing() True."""
    state = bundle.state
    state.set_host_counts({k: n for k in state.host_counts()})
    kwargs = {}
    if proxy:
        state.load_step_scalars()
        if bundle.variant is not None:
            kwargs = bundle.variant(state, SEED)
        state.set_host_counts({k: 0 for k in state.host_counts()})
        with monkeypatch.context() as m:
            _capturing(m)
            metrics = bundle.step_fn(state, batch, split_rngs(SEED, n, "cpu"),
                                     bundle.aux, **kwargs)
        moved = state.host_counts()
        assert moved == {k: 1 for k in moved}, moved
        state.set_host_counts({k: n + 1 for k in moved})
    else:
        metrics = bundle.step_fn(state, batch, split_rngs(SEED, n, "cpu"),
                                 bundle.aux)
        assert state.host_counts() == {k: n + 1 for k in
                                       state.host_counts()}
    return (chip_smoke._snapshot(chip_smoke.state_leaves(state)),
            _metrics(metrics), kwargs)


def _rot_steps():
    """A step at or past N for each of ustm's rotations."""
    from wsl4mis_torch.engine.methods.ustm import variant

    state = type("S", (), {})()
    out = {}
    for n in range(N, N + 64):
        state.step = n
        out.setdefault(variant(state, SEED)["rot_times"], n)
    assert sorted(out) == [0, 1, 2, 3], out
    return [out[k] for k in range(4)]


CASES = ([(m, N) for m in sorted(available_methods())
          if m not in ("ustm", "s2l", "scribblevc")]
         + [("ustm", f"rot{k}") for k in range(4)]
         + [("s2l", THR_ITER - 1), ("s2l", N),
            ("scribblevc", 9), ("scribblevc", N)])


@pytest.mark.parametrize("method,n", CASES)
def test_no_host_value_is_frozen(narrow, monkeypatch, method, n):
    rot = None
    if isinstance(n, str):  # ustm at rotation k
        rot = int(n[3:])
        n = _rot_steps()[rot]
    _, bundle, batch = _bundle(method)
    state = bundle.state
    state.set_host_counts({k: n for k in state.host_counts()})
    start = copy.deepcopy(state.state_dict())
    want, want_m, _ = _step_at(bundle, batch, n, False, monkeypatch)
    state.load_state_dict(copy.deepcopy(start))
    got, got_m, kwargs = _step_at(bundle, batch, n, True, monkeypatch)
    bad, worst = chip_smoke.leaves_diff(want, got)
    assert bad == [], (bad[:10], worst)
    assert want_m.keys() == got_m.keys()
    assert [k for k in want_m if not torch.equal(want_m[k], got_m[k])] == []
    if method == "s2l":
        assert kwargs == {"gate": n >= THR_ITER}
    elif method == "scribblevc":  # 11 slices at batch 4: 2 steps an epoch
        assert bundle.steps_per_epoch == 2
        assert kwargs == {"use_class_rep": n >= 10}
    elif method == "ustm":
        assert kwargs == {"rot_times": rot}
    else:
        assert kwargs == {} and bundle.variant is None


class _Decided(Exception):
    """Ends a step once it has shown its decision."""


def _spy_decisions(method, bundle, monkeypatch):
    """A list the step's own decisions are appended to as it runs; the
    step stops at the call that shows it (its first rot90, the
    pseudo-label term's cross-entropy, the model's forward)."""
    seen = []
    if method == "ustm":
        def spy(x, k, dims):
            seen.append(k)
            raise _Decided

        monkeypatch.setattr(torch, "rot90", spy)
    elif method == "s2l":
        ce = ts2l.losses.cross_entropy
        calls = []

        def spy(outputs, labels, **kw):
            calls.append(1)
            if len(calls) % 2 == 0:  # the pseudo-label term's
                seen.append(outputs.requires_grad)
                raise _Decided
            return ce(outputs, labels, **kw)

        monkeypatch.setattr(ts2l.losses, "cross_entropy", spy)
    else:
        def spy(*args, **kw):
            seen.append(kw["use_class_rep"])
            raise _Decided

        monkeypatch.setattr(bundle.model, "forward", spy)
    return seen


@pytest.mark.parametrize("method,start", [("ustm", 0), ("s2l", THR_ITER - 8),
                                          ("scribblevc", 2)])
def test_variant_pick_is_the_steps_decision(narrow, monkeypatch, method,
                                            start):
    _, bundle, batch = _bundle(method)
    state = bundle.state
    seen = _spy_decisions(method, bundle, monkeypatch)
    picks = []
    for n in range(start, start + PICK_STEPS):
        state.set_host_counts({k: n for k in state.host_counts()})
        picks.append(next(iter(bundle.variant(state, SEED).values())))
        with pytest.raises(_Decided):
            bundle.step_fn(state, batch, split_rngs(SEED, n, "cpu"),
                           bundle.aux)
    if method == "ustm":
        assert sorted(set(picks)) == [0, 1, 2, 3], picks
    assert seen == picks
    assert len(set(picks)) > 1  # both sides of the gates
