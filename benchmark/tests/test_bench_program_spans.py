"""The readers of the ``program_span`` metrics on hand-made span records:
their arithmetic, ``call_gap_ms.train``'s pairing, and None where there is
nothing to read."""

import os

import pytest

from conftest import BENCH
from harness import program_spans, spec

MS = 1_000_000  # ns
MAIN, FEED = 1, 2


def reader(name):
    return spec.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                            "bench_metric_" + name.replace(".", "_"))


def training_records():
    """Two 2-step calls on the main thread, each taking its batches (1 ms
    each), loading (0.5 ms) and replaying (0.25 ms) each step, then the
    sync (2 ms); the feed thread builds 4 batches of 3 ms. The gap from
    the first call's sync (ends at 10 ms) to the second call's first
    replay (starts at 14 ms) is 4 ms."""
    recs = [("loader.batch", FEED, t * MS, (t + 3) * MS)
            for t in (0, 3, 6, 9)]
    for t0 in (0, 10):
        recs += [("trainer.feed", MAIN, (t0 + 1) * MS, (t0 + 2) * MS),
                 ("trainer.feed", MAIN, (t0 + 2) * MS, (t0 + 3) * MS)]
        for s in (3, 5):
            recs += [("captured.load", MAIN, (t0 + s) * MS,
                      (t0 + s) * MS + MS // 2),
                     ("captured.replay", MAIN, (t0 + s + 1) * MS,
                      (t0 + s + 1) * MS + MS // 4)]
        recs.append(("trainer.sync", MAIN, (t0 + 8) * MS, (t0 + 10) * MS))
    return recs


def validation_records():
    """Two passes of 100 ms: 4 forwards of 2 ms, 4 copies of 10 ms and a
    zoom back of 50 ms each."""
    recs = []
    for p in (0, 100):
        recs.append(("val.pass", MAIN, p * MS, (p + 100) * MS))
        for c in range(4):
            t = p + 12 * c
            recs += [("val.forward", MAIN, t * MS, (t + 2) * MS),
                     ("val.copy", MAIN, (t + 2) * MS, (t + 12) * MS)]
        recs.append(("val.zoom_back", MAIN, (p + 48) * MS, (p + 98) * MS))
    return recs


@pytest.mark.parametrize("name,want", [
    ("feed_wait_ms.train", 4 * 1.0 / 4),
    ("feed_build_ms.train", 4 * 3.0 / 4),
    ("replay_launch_ms.train", (4 * 0.5 + 4 * 0.25) / 4),
    ("call_gap_ms.train", 4.0),
    ("chunk_launch_ms.infer", 8 * 2.0 / 2),
    ("chunk_wait_ms.infer", 8 * 10.0 / 2),
    ("zoom_back_ms.infer", 50.0),
])
def test_readers_arithmetic(monkeypatch, name, want):
    recs = (training_records() if name.endswith(".train")
            else validation_records())
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    assert reader(name).read({}) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "feed_wait_ms.train", "feed_build_ms.train", "replay_launch_ms.train",
    "call_gap_ms.train", "chunk_launch_ms.infer", "chunk_wait_ms.infer",
    "zoom_back_ms.infer"])
def test_readers_read_none_without_records(monkeypatch, name):
    monkeypatch.setattr(program_spans, "records", lambda: [])
    assert reader(name).read({}) is None
    # a validation reader finds no pass in a training segment, and back
    other = (validation_records() if name.endswith(".train")
             else training_records())
    monkeypatch.setattr(program_spans, "records", lambda: list(other))
    assert reader(name).read({}) is None


def test_call_gap_pairs_each_sync_with_the_next_replay_on_its_thread():
    recs = [
        ("trainer.sync", MAIN, 0, 2 * MS),
        ("captured.replay", FEED, 3 * MS, 4 * MS),  # another thread
        ("captured.replay", MAIN, 5 * MS, 6 * MS),  # 3 ms after the sync
        ("captured.replay", MAIN, 7 * MS, 8 * MS),  # no sync before it
        ("trainer.sync", MAIN, 9 * MS, 10 * MS),
        ("captured.replay", MAIN, 11 * MS, 12 * MS),  # 1 ms
        ("trainer.sync", MAIN, 13 * MS, 14 * MS),  # the segment's last
    ]
    assert program_spans.call_gap_ms(recs) == pytest.approx(2.0)
    assert program_spans.call_gap_ms(recs[-1:]) is None
    assert program_spans.call_gap_ms([]) is None


def test_records_of_the_program_and_of_a_program_without_spans(monkeypatch):
    """The records are the program's own; a program that keeps none (its
    profiling module has no ``span_records``) reads as no records."""
    from wsl4mis_torch.utils import profiling

    monkeypatch.setattr(profiling, "_records", [("val.pass", 1, 0, MS)])
    assert program_spans.records() == [("val.pass", 1, 0, MS)]
    monkeypatch.delattr(profiling, "span_records")
    assert program_spans.records() == []
    assert reader("zoom_back_ms.infer").read({}) is None
