"""The port's SHA-256 path against the JAX package, bit for bit (no
tolerance: the programs, the compiled circuits, the witnesses and the proof
bytes are exact).

The circuits are the port's copies in ``utils/circuits.py``: the
one-compression opcode circuit of ``tests/test_sha256.py`` and
``sha256_multiblock`` of ``tests/factories.py`` with 1 and 2 blocks, held
to the originals and taken through the port's translator
(``acir/translator.py``, ``ops/sha256.py``), compiler and native witness
core.  The proof parity test proves the 2^16-row opcode circuit on the CPU,
which takes many minutes, so it runs only with ``RUN_SLOW=1``, as the JAX
package's own SHA proofs do.
"""

import functools
import hashlib
import os

import numpy as np
import pytest

from tpu_acir_prover.acir import codec as jcodec
from tpu_acir_prover.acir import ir as jir
from tpu_acir_prover.acir.translator import translate_program as jtranslate
from tpu_acir_prover.circuit.compile import compile_circuit as jcompile
from tpu_acir_prover.prover.config import TEST_CONFIG as JTEST_CONFIG
from tpu_acir_prover.prover.prove import ProvingKey as OracleKey
from tpu_acir_prover.prover.prove import prove as oracle_prove
from tpu_acir_prover.prover.serialization import \
    serialize_proof as jserialize_proof
from tpu_acir_prover_torch.acir import codec, ir
from tpu_acir_prover_torch.acir.translator import (check_linked_outputs,
                                                   translate_program)
from tpu_acir_prover_torch.circuit.builder import CircuitBuilder
from tpu_acir_prover_torch.circuit.compile import compile_circuit
from tpu_acir_prover_torch.ops.sha256 import sha256_compress, word_from_var
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.prover.fused import prove_fused
from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
from tpu_acir_prover_torch.prover.serialization import serialize_proof
from tpu_acir_prover_torch.prover.verify import verify
from tpu_acir_prover_torch.utils import circuits

import factories
from test_sha256 import H0, ref_compress


def _jax_compression(seed=3):
    """The circuit of ``tests/test_sha256.py::test_sha256_opcode_prove_verify``
    on the JAX package's ``ir``."""
    rng = np.random.default_rng(seed)
    msg = [int(x) for x in rng.integers(0, 1 << 32, size=16)]
    state = list(H0)
    out = ref_compress(msg, state)
    op = jir.BlackBoxSha256Compression(
        tuple(jir.FunctionInput(i, 32) for i in range(16)),
        tuple(jir.FunctionInput(16 + i, 32) for i in range(8)),
        tuple(range(24, 32)))
    circ = jir.Circuit(32, [op], None, tuple(range(24)), (),
                       tuple(range(24, 32)))
    wm = {i: v for i, v in enumerate(msg)}
    wm.update({16 + i: v for i, v in enumerate(state)})
    wm.update({24 + i: v for i, v in enumerate(out)})
    return jir.Program([circ]), wm


# name -> (the port's builder, the original)
CASES = {
    "compression": (circuits.sha256_compression, _jax_compression),
    "multiblock-1": (functools.partial(circuits.sha256_multiblock, 1),
                     functools.partial(factories.sha256_multiblock, 1)),
    "multiblock-2": (functools.partial(circuits.sha256_multiblock, 2),
                     functools.partial(factories.sha256_multiblock, 2)),
}


@functools.lru_cache(maxsize=None)
def _port(name):
    """(program, witness map, translator, compiled circuit) of the port."""
    prog, wm = CASES[name][0]()
    tr = translate_program(prog)
    return prog, wm, tr, compile_circuit(tr.builder)


@functools.lru_cache(maxsize=None)
def _jax(name):
    prog, wm = CASES[name][1]()
    tr = jtranslate(prog)
    return prog, wm, tr, jcompile(tr.builder)


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_bytes_and_witness_match(name, tmp_path):
    """The port's circuit gives the original's program bytes, through
    either codec, its artifact and witness files, and its witness map."""
    prog, wm = CASES[name][0]()
    jprog, jwm = CASES[name][1]()
    data = jcodec.serialize_program(jprog)
    assert codec.serialize_program(prog) == data
    assert codec.serialize_program(codec.deserialize_program(data)) == data
    assert jcodec.serialize_program(jcodec.deserialize_program(
        codec.serialize_program(prog))) == data
    assert wm == jwm
    codec.save_program_artifact(str(tmp_path / "p.json"), prog)
    jcodec.save_program_artifact(str(tmp_path / "j.json"), jprog)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    codec.save_witness_stack(str(tmp_path / "p.gz"),
                             ir.WitnessStack([ir.StackItem(0, wm)]))
    jcodec.save_witness_stack(str(tmp_path / "j.gz"),
                              jir.WitnessStack([jir.StackItem(0, jwm)]))
    assert (tmp_path / "p.gz").read_bytes() == (tmp_path / "j.gz").read_bytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_translate_and_compile_match(name):
    """The translator, the compiler's rows and generator batches, and the
    native witness core, against the JAX package's."""
    prog, wm, tr, cc = _port(name)
    _, _, jtr, jcc = _jax(name)
    assert (cc.n, cc.num_vars, cc.k_shifts, cc.lookup_bits) == \
        (jcc.n, jcc.num_vars, jcc.k_shifts, jcc.lookup_bits)
    assert len(tr.builder.rows) == len(jtr.builder.rows)
    for f in ("selectors", "wire_vars", "sigma", "external_vars",
              "public_input_vars"):
        assert np.array_equal(getattr(cc, f), getattr(jcc, f)), f
    assert len(cc.gen_batches) == len(jcc.gen_batches)
    for a, b in zip(cc.gen_batches, jcc.gen_batches):
        assert a.op == b.op
        for f in ("out", "a", "b", "const"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    ext = tr.external_values(wm)
    assert np.array_equal(ext, jtr.external_values(wm))
    vals = cc.generate_witness(ext)
    assert np.array_equal(vals, jcc.generate_witness(ext))
    assert cc.check_constraints(vals) is None
    check_linked_outputs(tr, cc, prog.functions[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_reference(name):
    """Each compression's output words in the port's witness are
    ``ref_compress`` of its message and input state, the first state is the
    IV, and the witness satisfies every row (so the gadget's words, which
    the outputs are asserted equal to, are these)."""
    prog, wm, tr, cc = _port(name)
    vals = cc.generate_witness(tr.external_values(wm))
    assert cc.check_constraints(vals) is None

    def words(ws):
        return [int(vals[tr.witness_to_var[w]]) for w in ws]

    ops = prog.functions[0].opcodes
    state = list(H0)
    for op in ops:
        assert words(f.witness for f in op.hash_values) == state
        state = ref_compress(words(f.witness for f in op.inputs), state)
        assert words(op.outputs) == state
    assert words(prog.functions[0].return_values) == state


def _padded_blocks(msg):
    """SHA-256 padding of ``msg``, as 16-word blocks."""
    data = msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64) + \
        (8 * len(msg)).to_bytes(8, "big")
    words = [int.from_bytes(data[i:i + 4], "big")
             for i in range(0, len(data), 4)]
    return [words[i:i + 16] for i in range(0, len(words), 16)]


@pytest.mark.parametrize("length", [0, 3, 56, 119])
def test_gadget_digest_matches_hashlib(length):
    """The port's gadget, chained over a padded message (one block for 0
    and 3 bytes, two for 56 and 119), computes hashlib's digest in the
    circuit: the words are read from the generated witness."""
    msg = bytes(np.random.default_rng(length).integers(0, 256, size=length,
                                                       dtype=np.uint8))
    blocks = _padded_blocks(msg)
    b = CircuitBuilder()
    state = [word_from_var(b, b.constant(v)) for v in H0]
    msg_vars = []
    for _ in blocks:
        block = [b.add_external() for _ in range(16)]
        msg_vars += block
        state = sha256_compress(b, [word_from_var(b, v) for v in block],
                                state)
    cc = compile_circuit(b)
    vals = cc.generate_witness(np.array([w for blk in blocks for w in blk],
                                        dtype=np.uint64))
    assert cc.check_constraints(vals) is None
    digest = b"".join(int(vals[w.value]).to_bytes(4, "big") for w in state)
    assert digest == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrong_output_word_fails_constraints(name):
    """One output word off by a bit: the port's witness violates a row, the
    same row as the JAX package's."""
    prog, wm, tr, cc = _port(name)
    _, _, jtr, jcc = _jax(name)
    bad = dict(wm)
    bad[prog.functions[0].opcodes[-1].outputs[3]] ^= 1
    ext = tr.external_values(bad)
    row = cc.check_constraints(cc.generate_witness(ext))
    assert row is not None
    assert row == jcc.check_constraints(jcc.generate_witness(ext))


def test_long_message_fills_2_pow_20_rows():
    """``SHA_LONG_BLOCKS`` is the most chained blocks that compile to 2^20
    rows: a block adds a fixed count of builder rows, so the count for
    any number of blocks follows from 1, 2 and 3."""
    rows = [len(translate_program(circuits.sha256_multiblock(k)[0])
                .builder.rows) for k in (1, 2, 3)]
    per_block = rows[1] - rows[0]
    assert rows[2] - rows[1] == per_block == 39136
    fixed = rows[0] - per_block
    assert fixed + circuits.SHA_LONG_BLOCKS * per_block <= 1 << 20
    assert fixed + (circuits.SHA_LONG_BLOCKS + 1) * per_block > 1 << 20


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="2^16-row proofs on the CPU; RUN_SLOW=1")
def test_proof_bytes_match_jax():
    """The opcode circuit at TEST_CONFIG: the port's per-phase and fused
    proofs on the CPU give the JAX numpy prover's bytes, and the port's
    verifier accepts them."""
    _, wm, tr, cc = _port("compression")
    _, _, jtr, jcc = _jax("compression")
    ext = tr.external_values(wm)
    want = jserialize_proof(oracle_prove(OracleKey(jcc, JTEST_CONFIG, xp=np),
                                         jtr.external_values(wm)))
    pk = ProvingKey(cc, TEST_CONFIG, device="cpu")
    for prover in (prove, prove_fused):
        proof = prover(pk, ext)
        verify(pk.vk, proof)
        assert serialize_proof(proof) == want, prover.__name__
