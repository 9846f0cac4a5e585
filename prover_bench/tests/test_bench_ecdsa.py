"""Noir's ECDSA secp256k1 program through the benchmark's frozen reference:
the generator writes the port's fixture, the frozen translator compiles it
to the port's circuit, the reference's plain solve gives the port's witness
fill on every variable, and ``check`` holds the output to the backend's
verdict on the signature."""

import random

import numpy as np
import pytest

from prover_bench import reference
from prover_bench.frozen.acir import codec, ir
from prover_bench.programs import ecdsa
from tpu_acir_prover_torch.acir import codec as port_codec
from tpu_acir_prover_torch.acir.translator import translate_program
from tpu_acir_prover_torch.circuit.compile import compile_circuit
from tpu_acir_prover_torch.utils import circuits

SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The program's artifact translated by the frozen translator and by the
    port's, one witness map drawn from the seed."""
    art = str(tmp_path_factory.mktemp("ecdsa") / "p.json")
    codec.save_program_artifact(art, ecdsa.build({}))
    tr = translate_program(port_codec.load_program_artifact(art))
    wm = ecdsa.witness({}, ecdsa.draw({}, random.Random(SEED)))
    return reference.load_circuit(art), tr, compile_circuit(tr.builder), wm


def test_program_and_witness_are_the_ports_fixture(tmp_path):
    """The artifact decodes through the port's codec to the bytes of
    ``utils/circuits.ecdsa_secp256k1``; that fixture's own witness passes
    ``check``."""
    art, wit = str(tmp_path / "p.json"), str(tmp_path / "w.gz")
    codec.save_program_artifact(art, ecdsa.build({}))
    want, want_wm = circuits.ecdsa_secp256k1()
    assert port_codec.serialize_program(port_codec.load_program_artifact(
        art)) == port_codec.serialize_program(want)
    assert ecdsa.check({}, None, want_wm) == 0
    wm = ecdsa.witness({}, ecdsa.draw({}, random.Random(SEED)))
    codec.save_witness_stack(wit, ir.WitnessStack([ir.StackItem(0, wm)]))
    got = port_codec.load_witness_stack(wit).peek().witness
    assert got == wm and set(got) == set(want_wm) and got[ecdsa.OUTPUT] == 1


def test_frozen_translation_is_the_ports_circuit(compiled):
    circuit, tr, cc, _ = compiled
    shape = circuit.shape
    assert (shape.n, shape.log_n) == (cc.n, cc.log_n) == (1 << 17, 17)
    assert circuit.translation.builder.num_vars == cc.num_vars
    assert (shape.selectors == cc.selectors).all()
    assert (shape.wire_vars == cc.wire_vars).all()
    assert (shape.sigma == cc.sigma).all()            # the copy cycles
    assert shape.k_shifts == cc.k_shifts
    assert shape.lookup_bits == cc.lookup_bits == 16
    assert (shape.lookup_rows == cc.lookup_rows).all()
    assert shape.lookup_rows.size > 0
    assert (shape.table == cc.table).all()
    assert shape.num_public_inputs == cc.num_public_inputs == 0
    assert list(circuit.translation.builder.public_inputs) == \
        list(cc.public_input_vars)
    assert circuit.translation.witness_to_var == tr.witness_to_var


def test_reference_solve_is_the_ports_witness_fill(compiled):
    """Every variable of the plain solve equals the port's fill; the wire
    matrix and the lookup multiplicity column are the port's."""
    circuit, tr, cc, wm = compiled
    vals = reference.solve(circuit, wm)
    port = cc.generate_witness(tr.external_values(wm))
    assert cc.check_constraints(port) is None
    assert len(vals) == len(port)
    assert (np.array(vals, dtype=np.uint64) == port).all()
    wires = cc.wire_values(port)
    mine = reference.wire_columns(circuit, vals)
    assert (mine[:-1] == wires).all()
    assert (mine[-1] == cc.multiplicities(wires)).all()


def test_check_holds_the_output_to_the_backends_verdict():
    """A drawn signature checks; with s tweaked (the scan of
    ``utils/circuits.ecdsa_secp256k1(valid=False)``) until the backend's
    ``r <= R.x`` rule says 0, an output of 1 is counted wrong and one of 0
    is right."""
    inputs = ecdsa.draw({}, random.Random(SEED + 1))
    wm = ecdsa.witness({}, inputs)
    assert ecdsa.check({}, inputs, wm) == 0
    pk, r, s, h = ecdsa.signed(inputs)
    assert ecdsa.backend_accepts(pk, r, s, h) == 1
    for tweak in range(1, 64):
        if ecdsa.backend_accepts(pk, r, s ^ tweak, h) == 0:
            break
    else:
        raise AssertionError("no tweak of s gives the verdict 0")
    tampered = ecdsa.witness_for(pk, r, s ^ tweak, h, 1)
    assert ecdsa.check({}, inputs, tampered) == 1
    tampered[ecdsa.OUTPUT] = 0
    assert ecdsa.check({}, inputs, tampered) == 0


def _textbook(pk, r, s, h) -> int:
    """Textbook ECDSA's verdict: R.x mod n == r."""
    s_inv = pow(s, -1, ecdsa.ORDER)
    big_r = ecdsa.add(ecdsa.mul(h * s_inv % ecdsa.ORDER, ecdsa.G),
                      ecdsa.mul(r * s_inv % ecdsa.ORDER, pk))
    return int(big_r is not None and big_r[0] % ecdsa.ORDER == r)


def test_backend_rule_departs_from_textbook_ecdsa():
    """Both accept an honest signature; the backend also accepts an r it
    was not signed with wherever that r lies at or below the R it gives."""
    pk, r, s, h = ecdsa.signed(ecdsa.draw({}, random.Random(SEED + 2)))
    assert _textbook(pk, r, s, h) == ecdsa.backend_accepts(pk, r, s, h) == 1
    for tweak in range(1, 64):
        if ecdsa.backend_accepts(pk, r ^ tweak, s, h) == 1:
            break
    else:
        raise AssertionError("no tweak of r that the backend accepts")
    assert _textbook(pk, r ^ tweak, s, h) == 0
