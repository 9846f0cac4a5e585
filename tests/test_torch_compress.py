"""The port's proof compressor (``prover/compress.py``) given the query
indices the prover drew, on the CPU: each prover hands back the
transcript's own indices, the compressed bytes are those of the replay,
the verifier accepts them, and a malformed proof or wrong indices raise
``VerificationError`` as the replay does.

Imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_compress.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpu_acir_prover_torch.acir.translator import translate_program
from tpu_acir_prover_torch.circuit.builder import CircuitBuilder
from tpu_acir_prover_torch.circuit.compile import compile_circuit
from tpu_acir_prover_torch.prover.compress import (compress_proof,
                                                   decompress_proof)
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.prover.fused import prove_fused
from tpu_acir_prover_torch.prover.proof import Proof
from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
from tpu_acir_prover_torch.prover.serialization import (
    deserialize_compressed_proof, serialize_compressed_proof)
from tpu_acir_prover_torch.prover.verify import (VerificationError,
                                                 derive_transcript, verify)
from tpu_acir_prover_torch.utils import circuits

torch.set_num_threads(1)

# plain arithmetic, a memory block, and the LogUp lookup argument
NAMES = ["fibonacci", "memory_write", "lookup_bits=8"]
PROVERS = {"per_phase": prove, "fused": prove_fused}


@functools.lru_cache(maxsize=None)
def _key(name):
    """(proving key on the CPU, external values)."""
    if name == "lookup_bits=8":
        b = CircuitBuilder(lookup_bits=8)
        for bits in (8, 5, 19):
            b.range_check(b.add_external(), bits)
        cc, ext = compile_circuit(b), np.array([200, 31, (1 << 19) - 3],
                                               np.uint64)
    else:
        prog, wm = circuits.ALL_SMALL[name]()
        tr = translate_program(prog)
        cc, ext = compile_circuit(tr.builder), tr.external_values(wm)
    return ProvingKey(cc, TEST_CONFIG, device="cpu"), ext


@functools.lru_cache(maxsize=None)
def _proved(name, path):
    """(key, proof, the indices the prover handed back)."""
    pk, ext = _key(name)
    proof, indices = PROVERS[path](pk, ext, with_indices=True)
    return pk, proof, indices


def _compressed(pk, proof, **kw):
    return serialize_compressed_proof(compress_proof(pk.vk, proof, **kw))


@pytest.mark.parametrize("path", sorted(PROVERS))
@pytest.mark.parametrize("name", NAMES)
def test_handed_indices_compress_as_the_replay(name, path):
    pk, proof, indices = _proved(name, path)
    assert isinstance(proof, Proof)
    assert all(type(i) is int for i in indices)
    assert indices == derive_transcript(pk.vk, proof)[-1]
    handed = _compressed(pk, proof, indices=indices)
    assert handed == _compressed(pk, proof)
    verify(pk.vk, decompress_proof(pk.vk,
                                   deserialize_compressed_proof(handed)))


def _cut(proof, what):
    if what == "fri_cap_removed":
        return dataclasses.replace(proof, fri_caps=proof.fri_caps[:-1])
    if what == "fri_cap_added":
        return dataclasses.replace(
            proof, fri_caps=proof.fri_caps + proof.fri_caps[-1:])
    return dataclasses.replace(
        proof, fri_final_coeffs=proof.fri_final_coeffs[:-1])


@pytest.mark.parametrize("what", ["fri_cap_removed", "fri_cap_added",
                                  "final_coeff_removed"])
def test_malformed_proof_raises_as_the_replay(what):
    pk, proof, indices = _proved("fibonacci", "per_phase")
    bad = _cut(proof, what)
    with pytest.raises(VerificationError) as replayed:
        compress_proof(pk.vk, bad)
    with pytest.raises(VerificationError) as handed:
        compress_proof(pk.vk, bad, indices=indices)
    assert str(handed.value) == str(replayed.value)


@pytest.mark.parametrize("what", ["one_fewer", "one_more", "negative",
                                  "m", "fewer_rounds"])
def test_wrong_indices_raise(what):
    pk, proof, indices = _proved("fibonacci", "per_phase")
    m = (1 << pk.vk.log_n) << pk.vk.rate_bits
    idx = list(indices)
    if what == "one_fewer":
        idx = idx[:-1]
    elif what == "one_more":
        idx.append(0)
    elif what == "negative":
        idx[3] = -1
    elif what == "m":
        idx[0] = m
    else:
        proof = dataclasses.replace(proof, fri_queries=proof.fri_queries[:-1])
    with pytest.raises(VerificationError):
        compress_proof(pk.vk, proof, indices=idx)
