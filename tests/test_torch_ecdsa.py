"""Noir's ECDSA secp256k1 program in the port, held on the CPU to the
benchmark's plain reference: ``prover_bench/programs/ecdsa.py`` (the curve
in python ints and the reference backend's verdict) and
``prover_bench/reference.py`` (the plain solve, the key worked out again
from the circuit's layout, the frozen verifier).

- At the fixture's full size (2^17 rows), with no commitment: for three
  seeded signers, two honest and one with a tampered ``s``, the port's
  witness fill is the reference's solve variable for variable, its output
  bit is the backend's verdict, every constraint holds, and claiming the
  other verdict breaks one.  An enabled timer's span reads the fill's
  counters.
- At a small size: a circuit of the port's secp256k1 gadgets (a point
  add, a double and an ``nn_mul``), proven with ``TEST_CONFIG`` through
  both provers, verified by the frozen verifier under the key the
  reference derives from its own copy of the gadgets, with the same bytes
  whether a timer runs or not.

Imports no JAX and no JAX package:

    python -m pytest --noconftest tests/test_torch_ecdsa.py
"""

import random

import numpy as np
import pytest

from prover_bench import reference
from prover_bench.frozen.acir import codec
from prover_bench.frozen.circuit.builder import CircuitBuilder as \
    FrozenBuilder
from prover_bench.frozen.circuit.shape import circuit_shape
from prover_bench.frozen.ops import secp256k1 as frozen_sec
from prover_bench.frozen.prover.config import ProofConfig as FrozenConfig
from prover_bench.programs import ecdsa
from tpu_acir_prover_torch import native
from tpu_acir_prover_torch.acir import codec as port_codec
from tpu_acir_prover_torch.acir.translator import translate_program
from tpu_acir_prover_torch.circuit.builder import CircuitBuilder
from tpu_acir_prover_torch.circuit.compile import compile_circuit
from tpu_acir_prover_torch.ops import secp256k1 as sec
from tpu_acir_prover_torch.prover.compress import compress_proof
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.prover.fused import prove_fused
from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
from tpu_acir_prover_torch.prover.serialization import (
    serialize_compressed_proof, serialize_proof, serialize_vk)
from tpu_acir_prover_torch.utils.timing import PhaseTimer

SEED = 2 ** 33 + 181
SIGNERS = ["honest", "honest_again", "tampered_s"]
# the fixture's fill, as the benchmark's configuration states it
HINTS, HINT_OUTPUTS, SEGMENTS = 5214, 169079, 2543
LOOKUPS, LOOKUP_ROWS = 169398, 10588
# the gadgets' range checks at 2-bit lookups: the narrowest table whose
# trace is the smallest, 2^12 rows (1-bit lookups need 2^13)
GADGET_LOOKUP_BITS = 2


@pytest.fixture(scope="module")
def fixture_circuit(tmp_path_factory):
    """The program translated by the port and by the frozen reference."""
    art = str(tmp_path_factory.mktemp("ecdsa") / "p.json")
    codec.save_program_artifact(art, ecdsa.build({}))
    tr = translate_program(port_codec.load_program_artifact(art))
    return tr, compile_circuit(tr.builder), reference.load_circuit(art)


def _signed(which: str):
    """(public key, r, s, message hash, the backend's verdict)."""
    rng = random.Random(SEED + SIGNERS.index(which))
    pk, r, s, h = ecdsa.signed(ecdsa.draw({}, rng))
    if which == "tampered_s":
        s = next(s ^ t for t in range(1, 64)
                 if ecdsa.backend_accepts(pk, r, s ^ t, h) == 0)
    return pk, r, s, h, ecdsa.backend_accepts(pk, r, s, h)


@pytest.mark.parametrize("which", SIGNERS)
def test_fill_is_the_reference_solve_and_the_backends_verdict(
        fixture_circuit, which):
    tr, cc, circuit = fixture_circuit
    pk, r, s, h, verdict = _signed(which)
    assert verdict == (which != "tampered_s")
    wm = ecdsa.witness_for(pk, r, s, h, verdict)
    vals = cc.generate_witness(tr.external_values(wm))
    assert (np.array(reference.solve(circuit, wm), dtype=np.uint64)
            == vals).all()
    assert int(vals[tr.witness_to_var[ecdsa.OUTPUT]]) == verdict
    assert cc.check_constraints(vals) is None
    wm[ecdsa.OUTPUT] = 1 - verdict
    assert cc.check_constraints(
        cc.generate_witness(tr.external_values(wm))) is not None


def test_fill_counters_at_full_size(fixture_circuit):
    """Inside an enabled timer's span the fill counts its C and its hint
    seconds and gives the untimed fill's values; a disabled timer keeps
    nothing.  The fill's sizes are those the benchmark's configuration
    states.  The lookups are every wire of every lookup row, as
    ``multiplicities`` counts them: the builder's 169,398 and the last
    row's 10 unused slots."""
    tr, cc, _ = fixture_circuit
    pk, r, s, h, verdict = _signed("honest")
    ext = tr.external_values(ecdsa.witness_for(pk, r, s, h, verdict))
    vals = cc.generate_witness(ext)
    timers = [PhaseTimer(), PhaseTimer(enabled=False)]
    for timer in timers:
        with timer.phase("witness_fill"):
            assert (cc.generate_witness(ext) == vals).all()
    c = timers[0].counters
    assert set(c) == {"fill_hint_s", "fill_native_s"}
    assert c["fill_hint_s"] > 0 and c["fill_native_s"] > 0
    assert timers[1].counters == {}
    segments = cc.gen_program.segments
    assert (len(cc.hints), sum(e - s for s, e, hint in segments if hint),
            len(segments)) == (HINTS, HINT_OUTPUTS, SEGMENTS)
    assert len(tr.builder.pending_lookups) == LOOKUPS
    assert cc.lookup_rows.size == LOOKUP_ROWS
    assert 16 * LOOKUP_ROWS == \
        int(cc.multiplicities(cc.wire_values(vals)).sum())


def _gadgets(builder_cls, ops):
    """Two seeded points P, Q: P + Q, 2P and P.x * Q.y mod the field, in
    the gadgets of ``ops`` on a builder of ``builder_cls``."""
    rng = random.Random(SEED)
    p1, p2 = (ecdsa.mul(1 + rng.randrange(ecdsa.ORDER - 1), ecdsa.G)
              for _ in range(2))
    b = builder_cls(lookup_bits=GADGET_LOOKUP_BITS)
    p, q = ops.point_constant(b, p1), ops.point_constant(b, p2)
    outs = (ops.point_add(b, p, q), ops.point_double(b, p),
            ops.nn_mul(b, p.x, q.y))
    want = (ecdsa.add(p1, p2), ecdsa.add(p1, p1),
            p1[0] * p2[1] % ecdsa.FIELD)
    return b, outs, want


@pytest.fixture(scope="module")
def gadget_key():
    b, outs, want = _gadgets(CircuitBuilder, sec)
    frozen_b, _, _ = _gadgets(FrozenBuilder, frozen_sec)
    fields = ("rate_bits", "cap_height", "num_queries", "pow_bits",
              "final_poly_domain")
    vk = reference.derive_vk(
        reference.Circuit(None, circuit_shape(frozen_b)),
        FrozenConfig(**{k: getattr(TEST_CONFIG, k) for k in fields}), "cpu")
    return ProvingKey(compile_circuit(b), TEST_CONFIG, device="cpu"), \
        outs, want, vk


def _value(vals, nn) -> int:
    return sum(int(vals[v]) << (16 * i) for i, v in enumerate(nn.big.limbs))


def test_gadget_fill_is_the_python_int_curve(gadget_key, monkeypatch):
    """The coordinates are the python-int ``add``'s; the numpy fallback
    fills the same values, and both paths count their hint and arithmetic
    seconds."""
    pk, (added, doubled, product), want, _ = gadget_key
    cc = pk.compiled
    assert cc.lookup_bits == GADGET_LOOKUP_BITS and cc.n == 1 << 12
    ext = np.zeros(0, dtype=np.uint64)
    timers = [PhaseTimer(), PhaseTimer()]
    with timers[0].phase("witness_fill"):
        vals = cc.generate_witness(ext)
    assert cc.check_constraints(vals) is None
    got = ((_value(vals, added.x), _value(vals, added.y)),
           (_value(vals, doubled.x), _value(vals, doubled.y)),
           _value(vals, product))
    assert got == want
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with timers[1].phase("witness_fill"):
        assert (cc.generate_witness(ext) == vals).all()
    assert len(cc.hints) > 0
    for t in timers:
        assert t.counters["fill_hint_s"] > 0 and \
            t.counters["fill_native_s"] > 0


def test_gadget_proofs_verify_and_the_timer_changes_no_byte(gadget_key):
    """Per-phase untimed, fused timed: one proof's bytes, which the frozen
    verifier accepts under the reference's key; the timer holds the fill's
    counters."""
    pk, _, _, vk = gadget_key
    assert serialize_vk(pk.vk) == reference.vk_bytes(vk)
    ext = np.zeros(0, dtype=np.uint64)
    timer = PhaseTimer()
    proofs = [prove(pk, ext), prove_fused(pk, ext, timer=timer)]
    assert len({serialize_proof(p) for p in proofs}) == 1
    data = serialize_compressed_proof(compress_proof(pk.vk, proofs[-1]))
    assert reference.judge_proof(vk, data) == ""
    assert timer.counters["fill_hint_s"] > 0 and \
        timer.counters["fill_native_s"] > 0
    assert [n for n, _ in timer.phases][:2] == ["witness_fill", "inputs"]
