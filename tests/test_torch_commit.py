"""The port's column-blocked commit (``ProvingKey.commit`` with
``COMMIT_BLOCK``) against a one-block commit and the JAX package's numpy
``ProvingKey.commit``, bit for bit: coefficients, LDE and Merkle cap; and
proofs whose commits and FRI combination take several column blocks
against the one-block proof.  The port runs on the CPU, where its kernel
wrappers take the plain twins."""

import functools

import numpy as np
import pytest
import torch

from tpu_acir_prover.acir.translator import translate_program
from tpu_acir_prover.circuit.compile import compile_circuit
from tpu_acir_prover.field.gl import P, make_gl
from tpu_acir_prover.prover.config import TEST_CONFIG
from tpu_acir_prover.prover.prove import ProvingKey as OracleKey
from tpu_acir_prover.prover.prove import _mat_to_dev
from tpu_acir_prover.prover.prove import prove as oracle_prove
from tpu_acir_prover.prover.serialization import serialize_proof
from tpu_acir_prover_torch.field import gl
from tpu_acir_prover_torch.prover import fused
from tpu_acir_prover_torch.prover import prove as port
from tpu_acir_prover_torch.prover.verify import verify

import factories

torch.set_num_threads(1)

G = make_gl(np)


@functools.lru_cache(maxsize=None)
def _circuit(name):
    prog, wm = factories.ALL_SMALL[name]()
    tr = translate_program(prog)
    return compile_circuit(tr.builder), tr.external_values(wm)


@functools.lru_cache(maxsize=None)
def _key(name):
    return port.ProvingKey(_circuit(name)[0], TEST_CONFIG, device="cpu")


@functools.lru_cache(maxsize=None)
def _oracle_key(name):
    return OracleKey(_circuit(name)[0], TEST_CONFIG, xp=np)


def _u64(pair):
    return np.asarray(G.to_u64(pair))


def test_column_blocks_cover_every_column_once(monkeypatch):
    monkeypatch.setattr(port, "COMMIT_BLOCK", 3 * 64)
    assert port.column_blocks(64, 7) == [slice(0, 3), slice(3, 6),
                                         slice(6, 7)]
    assert port.column_blocks(1024, 7) == [slice(c, c + 1) for c in range(7)]
    monkeypatch.setattr(port, "COMMIT_BLOCK", 1 << 26)
    # 8 columns a block at 2^23 LDE rows; every column at once at 2^20
    assert len(port.column_blocks(1 << 23, 42)) == 6
    assert port.column_blocks(1 << 20, 43) == [slice(0, 43)]


@pytest.mark.parametrize("from_coeffs", [False, True],
                         ids=["values", "coeffs"])
@pytest.mark.parametrize("block", [1, 3, None], ids=["1", "3", "C"])
def test_blocked_commit_matches_one_block_and_numpy(monkeypatch, block,
                                                    from_coeffs):
    pk = _key("fibonacci")
    cols = 7
    vals = np.random.default_rng(block or 0).integers(
        0, P, size=(pk.n, cols), dtype=np.uint64)
    one = pk.commit(gl.from_u64(vals, "cpu"), from_coeffs)
    monkeypatch.setattr(port, "COMMIT_BLOCK", (block or cols) * pk.m)
    assert len(port.column_blocks(pk.m, cols)) == -(-cols // (block or cols))
    got = pk.commit(gl.from_u64(vals, "cpu"), from_coeffs)
    ref = _oracle_key("fibonacci").commit(_mat_to_dev(G, vals), from_coeffs)
    for a, b, want in ((got.coeffs, one.coeffs, ref.coeffs),
                       (got.lde, one.lde, ref.lde)):
        assert torch.equal(a, b)
        assert np.array_equal(gl.to_u64(a), _u64(want))
    assert np.array_equal(got.tree.cap_u64(), one.tree.cap_u64())
    assert np.array_equal(got.tree.cap_u64(), ref.tree.cap_u64())


@pytest.mark.parametrize("name", ["fibonacci", "range_33"])
def test_proofs_over_column_blocks_match_one_block(monkeypatch, name):
    """Two columns a block: the key's commit, every commit of the proof and
    the FRI combination run over several blocks; the fused and per-phase
    proofs keep the numpy oracle's bytes."""
    cc, ext = _circuit(name)
    want = serialize_proof(oracle_prove(_oracle_key(name), ext))
    calls = []
    real = port.column_blocks

    def spy(rows, cols):
        blocks = real(rows, cols)
        calls.append(len(blocks))
        return blocks

    monkeypatch.setattr(port, "column_blocks", spy)
    monkeypatch.setattr(port, "COMMIT_BLOCK", 2 << (cc.log_n +
                                                    TEST_CONFIG.rate_bits))
    pk = port.ProvingKey(cc, TEST_CONFIG, device="cpu")
    proof = fused.prove_fused(pk, ext)
    verify(pk.vk, proof)
    assert serialize_proof(proof) == want
    assert serialize_proof(port.prove(pk, ext)) == want
    assert max(calls) > 1
