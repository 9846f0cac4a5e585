"""Shared by ``tests/test_torch_sharded.py`` and
``tests/test_torch_sharded_lookup.py``: the test circuits on both packages
and the check that ``prove_sharded``'s bytes equal the JAX package's numpy
prover's and the port's single-device prover's."""

import functools

import numpy as np

from tpu_acir_prover.acir import codec as jcodec
from tpu_acir_prover.acir.translator import translate_program as jtranslate
from tpu_acir_prover.circuit import builder as jbuilder
from tpu_acir_prover.circuit.compile import compile_circuit as jcompile
from tpu_acir_prover.prover import serialization as jser
from tpu_acir_prover.prover.config import TEST_CONFIG as JTEST_CONFIG
from tpu_acir_prover.prover.prove import ProvingKey as OracleKey
from tpu_acir_prover.prover.prove import prove as oracle_prove
from tpu_acir_prover_torch.acir import codec
from tpu_acir_prover_torch.acir.translator import translate_program
from tpu_acir_prover_torch.circuit import builder
from tpu_acir_prover_torch.circuit.compile import compile_circuit
from tpu_acir_prover_torch.parallel.mesh import Mesh
from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                  prove_sharded)
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
from tpu_acir_prover_torch.prover.serialization import serialize_proof
from tpu_acir_prover_torch.prover.verify import verify

import factories

SHARDS = [1, 2, 4, 8]


def _lookup_builder(mod):
    """The lookup circuit of ``tests/test_torch_prover.py`` on a builder
    module of either package."""
    b = mod.CircuitBuilder(lookup_bits=8)
    for bits in (8, 5, 19):
        b.range_check(b.add_external(), bits)
    return b


@functools.lru_cache(maxsize=None)
def case(name):
    """(port circuit, JAX circuit, external values) of a test circuit."""
    if name == "lookup_bits=8":
        ext = np.array([200, 31, (1 << 19) - 3], dtype=np.uint64)
        return (compile_circuit(_lookup_builder(builder)),
                jcompile(_lookup_builder(jbuilder)), ext)
    prog, wm = factories.ALL_SMALL[name]()
    tr = translate_program(codec.deserialize_program(
        jcodec.serialize_program(prog)))
    return (compile_circuit(tr.builder), jcompile(jtranslate(prog).builder),
            tr.external_values(wm))


@functools.lru_cache(maxsize=None)
def _want(name):
    """The JAX numpy oracle's bytes, and the port's single-device bytes and
    constants cap."""
    cc, jcc, ext = case(name)
    oracle = jser.serialize_proof(oracle_prove(
        OracleKey(jcc, JTEST_CONFIG, xp=np), ext))
    pk = ProvingKey(cc, TEST_CONFIG, device="cpu")
    return oracle, serialize_proof(prove(pk, ext)), pk.vk.constants_cap


def check_sharded_proof(name, shards):
    """prove_sharded over ``shards`` CPU shards: the unsharded key's
    constants cap, the verifier accepts, the bytes equal the port's
    single-device proof's and the JAX numpy oracle's."""
    cc, _, ext = case(name)
    oracle, single, cap = _want(name)
    spk = ShardedProvingKey(cc, TEST_CONFIG, mesh=Mesh.on("cpu", shards))
    assert spk.vk.constants_cap == cap
    proof = prove_sharded(spk, ext, check_constraints=True)
    verify(spk.vk, proof)
    data = serialize_proof(proof)
    assert data == single
    assert data == oracle
