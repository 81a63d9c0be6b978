"""The port's spans (``utils.profiling.span``) on the CPU: off without a
profiler, one record and one trace range each under one, from the feed's
thread too, and at the Trainer's and the validation pass's boundaries."""

from __future__ import annotations

import itertools
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from wsl4mis_torch.data.loader import prefetch  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods.common import MethodBundle  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.eval.val2d import VolumePredictor  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils import profiling  # noqa: E402
from wsl4mis_torch.utils.profiling import (  # noqa: E402
    clear_spans,
    span,
    span_records,
    span_summary,
)


@pytest.fixture(autouse=True)
def no_records():
    clear_spans()
    yield
    clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(records):
    return [r[0] for r in records]


def _events(prof, prefix):
    return [(e.name(), e.start_ns()) for e in
            prof.profiler.kineto_results.events()
            if e.name().startswith(prefix)]


def test_off_without_a_profiler_records_nothing(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        no_range)
    assert span("a") is span("b")  # one shared no-op
    for name in ("trainer.feed", "val.pass"):
        with span(name):
            pass
    assert span_records() == []


def test_on_one_record_and_one_trace_range_each_on_one_clock():
    with _cpu_profile():  # a process's first range resolves its op: slow
        with span("t.warm"):
            pass
    assert _names(span_records()) == ["t.warm"]
    clear_spans()
    with _cpu_profile() as prof:
        with span("t.outer"):
            with span("t.inner"):
                torch.ones(8).sum()
        with span("t.inner"):
            pass
    recs = span_records()
    assert _names(recs) == ["t.inner", "t.outer", "t.inner"]
    me = threading.get_ident()
    assert all(r[1] == me and r[2] <= r[3] for r in recs)
    events = _events(prof, "t.")
    assert sorted(n for n, _ in events) == sorted(_names(recs))
    # the records' stamps are on the profiler's clock: the same span starts
    # within 1 ms in both
    for name in ("t.outer", "t.inner"):
        ours = sorted(r[2] for r in recs if r[0] == name)
        theirs = sorted(s for n, s in events if n == name)
        for a, b in zip(ours, theirs):
            assert abs(a - b) < 1_000_000, (name, a - b)
    # the profiler's stop leaves the flag off: no more records
    with span("t.after"):
        pass
    assert "t.after" not in _names(span_records())


def test_a_span_in_the_feed_thread_is_recorded():
    with _cpu_profile():
        got = list(prefetch(iter(range(3)), size=1))
    assert got == [0, 1, 2]
    feed = [r for r in span_records() if r[0] == "loader.batch"]
    # each item, and the draw that found the stream's end
    assert len(feed) == 4
    assert {r[1] for r in feed} != {threading.get_ident()}


def test_records_from_many_threads_lose_none():
    """Threads appending at once, with the interpreter switching threads as
    often as it can: every span is kept."""
    threads, each = 16, 200

    def work():
        for _ in range(each):
            with span("t.stress"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert _names(span_records()).count("t.stress") == threads * each


def test_summary_counts_and_ms_a_step():
    recs = [("a", 1, 0, 2_000_000), ("a", 1, 5, 1_000_005),
            ("b", 2, 0, 500_000)]
    assert span_summary(recs, 3) == {
        "a": {"count": 2, "total_ms": 3.0, "ms_per_step": 1.0},
        "b": {"count": 1, "total_ms": 0.5, "ms_per_step": 0.5 / 3}}
    assert span_summary(recs)["a"]["ms_per_step"] is None


def test_trace_writes_the_span_summary_and_clears(tmp_path):
    with profiling.trace(str(tmp_path)):
        with span("t.block"):
            pass
    with open(tmp_path / "spans.json") as f:
        assert json.load(f)["t.block"]["count"] == 1
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert span_records() == []


def test_trainer_records_each_feed_and_each_log_sync(tmp_path):
    """An eager K = 2 run of 8 steps, logging every call: a feed span a
    batch, a sync span a call, on the Trainer's thread, in call order."""
    cfg = TrainConfig(snapshot_root=str(tmp_path), device="cpu",
                      max_iterations=8, steps_per_call=2, log_every=2,
                      val_every=10 ** 6, ckpt_every=10 ** 6)
    model = torch.nn.Linear(1, 1)
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), 0.01, cfg.max_iterations))

    def step_fn(state, batch, rngs, aux=None):
        loss = model(torch.ones(1)).sum()
        state.minimize(loss)
        return {"total_loss": loss.detach()}

    hooked = []
    bundle = MethodBundle(
        model=model, state=state, step_fn=step_fn,
        data_iter=itertools.repeat({"index": np.zeros(2, np.int32)}),
        val_volumes=None, steps_per_epoch=1,
        host_hook=lambda b, s, it: hooked.append(it))
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    trainer._snapshot_code = lambda: None
    with _cpu_profile():
        trainer.train()
    recs = [r for r in span_records() if r[0].startswith("trainer.")]
    me = threading.get_ident()
    assert {r[1] for r in recs} == {me}
    order = [r[0] for r in sorted(recs, key=lambda r: r[2])]
    call = ["trainer.feed", "trainer.feed", "trainer.sync", "trainer.hook"]
    assert order == call * 4
    assert hooked == [2, 4, 6, 8]
    assert any(r[0] == "loader.batch" for r in span_records())


def test_validation_pass_spans_cover_the_pass():
    """One pass over three volumes in two 16-slice chunks: a forward and a
    copy span a chunk and one zoom-back, which together take no more than
    the pass and at least 90% of it."""
    model = net_factory("unet", 4, dtype=torch.float32,
                        features=(8, 16, 32, 64, 128))
    model.eval()
    rng = np.random.RandomState(0)
    volumes = [rng.rand(5, 40, 48).astype(np.float32) for _ in range(3)]
    pred = VolumePredictor(model, (64, 64), device="cpu", bucket=8,
                           chunk=16)
    pred.predict_volumes(volumes)  # stacks and caches the chunks
    with _cpu_profile():
        out = pred.predict_volumes(volumes)
    assert [o.shape for o in out] == [(5, 40, 48)] * 3
    recs = span_records()
    count = {n: _names(recs).count(n) for n in set(_names(recs))}
    assert count == {"val.pass": 1, "val.forward": 2, "val.copy": 2,
                     "val.zoom_back": 1}
    (_, _, p0, p1), = [r for r in recs if r[0] == "val.pass"]
    parts = [r for r in recs if r[0] != "val.pass"]
    assert all(p0 <= s <= e <= p1 for _, _, s, e in parts)
    inside = sum(e - s for _, _, s, e in parts)
    assert 0.9 * (p1 - p0) <= inside <= p1 - p0
