"""The witness fill's counter readers, ``hint_fill_ms`` and
``native_fill_ms``: the median over the window's proof records of the
program's ``fill_hint_s`` and ``fill_native_s``, in ms, and nothing where
the records lack the counters (a program that does not split its fill)."""

import pytest

from prover_bench import harness, metrics
from tpu_acir_prover_torch.utils import timing

READERS = ["hint_fill_ms", "native_fill_ms"]


def _record(start, end, hint_s=None, native_s=None):
    counters = {"gc_pause_s": 0.0, "gc_collections": {0: 0, 1: 0, 2: 0}}
    if hint_s is not None:
        counters.update(fill_hint_s=hint_s, fill_native_s=native_s)
    return {"proof_id": 0, "start": start, "end": end, "spans": [],
            "profiler_offset_ns": 0, "counters": counters}


def _window():
    proofs = [harness.Proof(i, s, e, {}, "")
              for i, (s, e) in enumerate([(10.0, 11.0), (11.0, 12.0),
                                          (12.0, 13.0)])]
    return harness.Run(proofs, 3.0, 1.0, 0, None, None)


def test_fill_readers_take_the_median_of_the_window_records(monkeypatch):
    recs = [_record(1.0, 2.0, 9.0, 9.0),             # a warm-up proof
            _record(10.1, 10.9, 0.600, 0.070),
            _record(11.1, 11.9, 0.450, 0.090),
            _record(12.1, 12.9, 0.720, 0.060),
            _record(12.5, 13.5, 9.0, 9.0)]           # past the window's end
    monkeypatch.setattr(timing, "finished", lambda: recs)
    run = _window()
    assert metrics.load("hint_fill_ms").read(run) == pytest.approx(600.0)
    assert metrics.load("native_fill_ms").read(run) == pytest.approx(70.0)


@pytest.mark.parametrize("name", READERS)
def test_fill_readers_give_nothing_without_the_counters(monkeypatch, name):
    run = _window()
    # the parent's program: records without the fill's counters
    monkeypatch.setattr(timing, "finished",
                        lambda: [_record(10.1, 10.9), _record(11.1, 11.9)])
    assert metrics.load(name).read(run) is None
    monkeypatch.setattr(timing, "finished", lambda: [])
    assert metrics.load(name).read(run) is None
    monkeypatch.delattr(timing, "finished")
    assert metrics.load(name).read(run) is None

