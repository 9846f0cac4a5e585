"""The readers of the program's own proof records (``records.py``) and of
the compression's spans: only the records of the window's proofs count,
and a program without the records or spans gives no number; a proof timed
by the harness leaves its spans in its record."""

import pytest

from prover_bench import harness, metrics
from tpu_acir_prover_torch.utils import timing

COUNTERS = ("gc_ms", "replay_device_ms", "quotient_device_ms")


def _record(start, end, gc_s, replay_s=None, quotient_s=None):
    counters = {"gc_pause_s": gc_s, "gc_collections": {0: 1, 1: 0, 2: 0}}
    if replay_s is not None:
        counters["replay_device_s"] = replay_s
    if quotient_s is not None:
        counters["phase_device_s"] = {"quotient": quotient_s}
    return {"proof_id": 0, "start": start, "end": end, "spans": [],
            "profiler_offset_ns": 0, "counters": counters}


def _run(phases=None):
    proofs = [harness.Proof(i, s, e, phases or {}, "")
              for i, (s, e) in enumerate([(10.0, 11.0), (11.0, 12.0),
                                          (12.0, 13.0)])]
    return harness.Run(proofs, 3.0, 1.0, 0, None, None)


def test_counter_readers_take_the_window_proofs_records(monkeypatch):
    recs = [_record(1.0, 2.0, 9.0, 9.0, 9.0),        # a warm-up proof
            _record(10.1, 10.9, 0.001, 0.090, 0.120),
            _record(11.1, 11.9, 0.004, 0.094, 0.130),
            _record(12.1, 12.9, 0.001, 0.092, 0.125),
            _record(12.5, 13.5, 9.0, 9.0, 9.0)]      # past the window's end
    monkeypatch.setattr(timing, "finished", lambda: recs)
    run = _run()
    assert metrics.load("gc_ms").read(run) == pytest.approx(2.0)
    assert metrics.load("replay_device_ms").read(run) == pytest.approx(92.0)
    assert metrics.load("quotient_device_ms").read(run) == \
        pytest.approx(125.0)


def test_counter_readers_give_nothing_without_records(monkeypatch):
    run = _run()
    monkeypatch.setattr(timing, "finished", lambda: [])
    assert [metrics.load(m).read(run) for m in COUNTERS] == [None] * 3
    # a program whose records lack the device counters (the other path)
    monkeypatch.setattr(timing, "finished",
                        lambda: [_record(10.1, 10.9, 0.0)])
    assert metrics.load("gc_ms").read(run) == 0.0
    assert metrics.load("replay_device_ms").read(run) is None
    assert metrics.load("quotient_device_ms").read(run) is None
    # a program without the log at all
    monkeypatch.delattr(timing, "finished")
    assert [metrics.load(m).read(run) for m in COUNTERS] == [None] * 3


def test_compress_ms_sums_the_two_spans():
    run = _run({"compress_transcript": 0.1, "compress_prune": 0.02,
                "serialize": 0.5})
    assert metrics.load("compress_ms").read(run) == pytest.approx(120.0)
    assert metrics.load("compress_ms").read(_run({"fused_device": 1.0})) \
        is None


@pytest.mark.parametrize("traced", [False, True])
def test_a_harness_timed_proof_keeps_its_spans(tmp_path, traced):
    """The harness's timer marks each phase and still lets the program's
    timer keep the span: the proof's record in ``timing.finished()`` holds
    the spans, in the timer's order and with its seconds."""
    import random
    from prover_bench import reference
    from prover_bench.frozen.acir import codec, ir
    from prover_bench.programs import square_chain
    from tpu_acir_prover_torch import api
    cfg = {"steps": 20,
           "proof_config": {"rate_bits": 3, "cap_height": 1,
                            "num_queries": 8, "pow_bits": 4,
                            "final_poly_domain": 64}}
    art, wit = str(tmp_path / "p.json"), str(tmp_path / "w.gz")
    codec.save_program_artifact(art, square_chain.build(cfg))
    codec.save_witness_stack(wit, ir.WitnessStack([ir.StackItem(
        0, square_chain.witness(cfg, square_chain.draw(
            cfg, random.Random(2 ** 33 + 5))))]))
    timer = harness._phase_timer(traced)
    api.prove_file(art, wit, str(tmp_path / "proof.bin"),
                   reference.proof_config(cfg), "cpu", timer=timer)
    api._CACHE.clear()
    rec = timing.finished()[-1]
    assert rec["proof_id"] == timer.proof_id
    spans = rec["spans"]
    assert [n for n, _, _ in spans] == [n for n, _ in timer.phases]
    assert {"witness_fill", "compress_transcript", "serialize"} <= \
        {n for n, _, _ in spans}
    for (_, t0, t1), (_, s) in zip(spans, timer.phases):
        assert (t1 - t0) * 1e-9 == pytest.approx(s)
