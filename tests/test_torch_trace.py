"""The port's per-proof trace (``utils/timing.py``) on the CPU: the spans
that ``api.prove_file`` opens on the fused and the per-phase path, their
clock against ``torch.profiler``'s, the collector's and the witness
fill's counters, the open span's timer, the bounded log of finished
proofs, that a proof without a timer keeps nothing, and the CLI's
``TPU_ACIR_TIMING`` switch.

Imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_trace.py
"""

import gc
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_acir_prover_torch import api, cli
from tpu_acir_prover_torch.acir import codec, ir
from tpu_acir_prover_torch.prover import verify
from tpu_acir_prover_torch.prover.compress import compress_proof
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.prover.serialization import (
    deserialize_proof, serialize_compressed_proof)
from tpu_acir_prover_torch.utils import circuits, timing
from tpu_acir_prover_torch.utils.timing import PhaseTimer

# the spans of one prove_file call, in call order
HEAD = ["key_lookup", "witness_read", "witness_fill", "inputs"]
TAIL = ["assemble", "compress_transcript", "compress_prune", "serialize",
        "write"]
SPANS = {
    "fused": HEAD + ["fused_device"] + TAIL,
    "per_phase": HEAD + [
        "transcript", "wire_commit", "transcript", "permutation_z",
        "transcript", "quotient", "transcript", "openings", "fri",
        "pow_grind", "transcript", "queries"] + TAIL,
}
FUSED_ENV = {"fused": "1", "per_phase": "0"}
# the witness fill's counters (circuit/compile.py generate_witness)
FILL = ["fill_native_s", "fill_hint_s"]


@pytest.fixture
def files(tmp_path, monkeypatch):
    """A small program's artifact, its witness file and a proof path; the
    per-phase prover, the faster of the two on the CPU, unless a test
    sets ``TPU_ACIR_FUSED`` itself."""
    monkeypatch.setenv("TPU_ACIR_FUSED", "0")
    prog, wm = circuits.fibonacci()
    paths = [str(tmp_path / n) for n in ("prog.json", "w.gz", "proof")]
    codec.save_program_artifact(paths[0], prog)
    codec.save_witness_stack(paths[1],
                             ir.WitnessStack([ir.StackItem(0, wm)]))
    return paths


def _prove(files, timer=None):
    return api.prove_file(*files, TEST_CONFIG, "cpu", timer=timer)


@pytest.mark.parametrize("path", ["fused", "per_phase"])
def test_spans_cover_prove_file_in_call_order(files, monkeypatch, path):
    monkeypatch.setenv("TPU_ACIR_FUSED", FUSED_ENV[path])
    untimed = _prove(files)
    timer = PhaseTimer()
    t0 = time.perf_counter_ns()
    timed = _prove(files, timer)
    wall = time.perf_counter_ns() - t0
    assert timed == untimed
    assert [n for n, _ in timer.phases] == SPANS[path]
    assert [n for n, _, _ in timer.spans] == SPANS[path]
    # one level deep, disjoint, inside the call
    for (_, _, end), (_, start, _) in zip(timer.spans, timer.spans[1:]):
        assert end <= start
    assert t0 <= timer.spans[0][1]
    assert timer.spans[-1][2] - t0 <= wall
    total = sum(e - s for _, s, e in timer.spans)
    assert total <= wall
    assert abs(timer.total() * 1e9 - total) < 1e3
    # what no span holds is the spans' own entry and exit
    assert wall - total < 0.1 * wall
    rec = timing.finished()[-1]
    assert rec["proof_id"] == timer.proof_id
    assert rec["spans"] == timer.spans
    assert rec["start"] * 1e9 <= timer.spans[0][1]
    assert timer.spans[-1][2] <= rec["end"] * 1e9
    assert rec["counters"] is timer.counters
    assert set(rec["counters"]) == {"gc_pause_s", "gc_collections", *FILL,
                                    "compress_replays"}


@pytest.mark.parametrize("path", ["fused", "per_phase"])
def test_prove_file_hands_the_compressor_its_indices(files, monkeypatch,
                                                     path):
    """Under ``prove_file`` the compressor takes the prover's query
    indices: no transcript replay, ``compress_replays`` 0 in the record."""
    monkeypatch.setenv("TPU_ACIR_FUSED", FUSED_ENV[path])
    replays = []
    real = verify.derive_transcript

    def spy(*a, **k):
        replays.append(a)
        return real(*a, **k)

    monkeypatch.setattr(verify, "derive_transcript", spy)
    _prove(files, PhaseTimer())
    assert replays == []
    c = timing.finished()[-1]["counters"]
    assert c["compress_replays"] == 0 and type(c["compress_replays"]) is int


def test_bare_compress_proof_counts_its_replay(files):
    """A caller that holds only the proof has the transcript replayed,
    counted once; the bytes are ``prove_file``'s."""
    data = _prove(files)
    raw = api.prove_file(*files, TEST_CONFIG, "cpu", compress=False)
    _, pk = api.load_and_compile(files[0], TEST_CONFIG, "cpu")
    timer = PhaseTimer()
    cp = compress_proof(pk.vk, deserialize_proof(raw), timer=timer)
    assert timer.counters == {"compress_replays": 1}
    assert [n for n, _ in timer.phases] == ["compress_transcript",
                                            "compress_prune"]
    assert serialize_compressed_proof(cp) == data


def test_timer_spans_of_each_call_in_its_record(files):
    """A timer passed to two calls keeps both calls' spans; each record
    holds its own call's, under its own proof id."""
    timer = PhaseTimer()
    _prove(files, timer)
    first = timing.finished()[-1]
    _prove(files, timer)
    second = timing.finished()[-1]
    assert second["proof_id"] == first["proof_id"] + 1
    assert timer.spans == first["spans"] + second["spans"]
    assert first["end"] <= second["start"]


@pytest.mark.parametrize("timer", [None, PhaseTimer(enabled=False)],
                         ids=["none", "disabled"])
def test_no_timer_keeps_nothing(files, monkeypatch, timer):
    """No collector callback while the call runs, no record in the log and
    no mark in a profiler's trace."""
    _prove(files)
    seen = []
    real = api.compress_proof

    def spy(*a, **k):
        seen.append(list(gc.callbacks))
        return real(*a, **k)

    monkeypatch.setattr(api, "compress_proof", spy)
    callbacks = list(gc.callbacks)
    log = list(timing.finished())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _prove(files, timer)
    assert seen == [callbacks] and gc.callbacks == callbacks
    assert list(timing.finished()) == log
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert any(n.startswith("aten::") for n in names)   # it saw the call
    assert not names & set(SPANS["fused"] + SPANS["per_phase"])


def test_span_holds_the_profiler_events_inside_it():
    """Under ``torch.profiler`` a span is marked with its name, and an op
    run inside it starts and ends inside its [start_ns, end_ns], put on
    the profiler's clock by the record's offset."""
    x = torch.arange(1 << 12)
    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.proof(timer):
            with timer.phase("outer_work"):
                time.sleep(0.002)
                x.add(1)
                time.sleep(0.002)
    rec = timing.finished()[-1]
    (name, s, e), = rec["spans"]
    off = rec["profiler_offset_ns"]
    adds = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name() == "aten::add"]
    marks = [ev for ev in prof.profiler.kineto_results.events()
             if ev.name() == "outer_work"]
    assert len(adds) == 1 and len(marks) == 1
    assert s + off <= adds[0].start_ns() <= adds[0].end_ns() <= e + off
    assert marks[0].start_ns() <= adds[0].start_ns()
    assert adds[0].end_ns() <= marks[0].end_ns()


def test_gc_collect_inside_prove_file_is_counted(files, monkeypatch):
    real = api.serialize_compressed_proof

    def collecting(*a, **k):
        gc.collect()
        return real(*a, **k)

    monkeypatch.setattr(api, "serialize_compressed_proof", collecting)
    timer = PhaseTimer()
    _prove(files, timer)
    c = timing.finished()[-1]["counters"]
    assert c["gc_collections"][2] >= 1
    assert c["gc_pause_s"] > 0
    assert c is timer.counters


def test_log_keeps_its_maxlen():
    log = timing.finished()
    n = log.maxlen + 10
    timer = PhaseTimer()
    for _ in range(n):
        with timing.proof(timer):
            pass
    assert len(log) == log.maxlen == 4096
    ids = [r["proof_id"] for r in log]
    assert ids == list(range(timer.proof_id - log.maxlen + 1,
                             timer.proof_id + 1))



def test_open_timer_is_the_enabled_timer_whose_span_is_open():
    """What the witness fill counts into: nothing outside a span, inside a
    disabled timer's span, or after a span that raised."""
    timer = PhaseTimer()
    assert timing.open_timer() is None
    with timer.phase("a"):
        assert timing.open_timer() is timer
    with PhaseTimer(enabled=False).phase("b"):
        assert timing.open_timer() is None
    with pytest.raises(ValueError), timer.phase("c"):
        raise ValueError
    assert timing.open_timer() is None
    assert [n for n, _ in timer.phases] == ["a"]

@pytest.mark.parametrize("switch", [None, "1"], ids=["unset", "set"])
def test_cli_timing_switch(files, monkeypatch, capsys, switch):
    monkeypatch.setenv("TPU_ACIR_FUSED", "1")
    if switch is None:
        monkeypatch.delenv("TPU_ACIR_TIMING", raising=False)
    else:
        monkeypatch.setenv("TPU_ACIR_TIMING", switch)
    size = len(timing.finished())
    before = timing.finished()[-1] if size else None
    prog, wit, out = files
    assert cli.main(["prove", "-b", prog, "-w", wit, "-o", out,
                     "--test-config", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    last = timing.finished()[-1] if len(timing.finished()) else None
    if switch is None:
        assert err == ""
        assert last is before
        return
    lines = err.splitlines()
    assert [ln.split()[0] for ln in lines[:len(SPANS["fused"])]] == \
        SPANS["fused"]
    assert lines[len(SPANS["fused"])].split()[0] == "total"
    shown = [ln.split()[0] for ln in lines[len(SPANS["fused"]) + 1:]]
    assert shown == ["gc_pause_s", "gc_collections[0]",
                     "gc_collections[1]", "gc_collections[2]", *FILL,
                     "compress_replays"]
    assert last is not before and [n for n, _, _ in last["spans"]] == \
        SPANS["fused"]
