"""The port's copies of the JAX package's host modules against the
originals, on the CPU: field scalars and the numpy limb namespace, the
Poseidon2 constants and int permutation, the ACIR codec, translator and
circuit compiler (native witness core included), the program factories in
``utils/circuits.py``, the benchmark circuit in ``utils/bench_circuits.py``,
the verifier, compression and serialization.  Also
the native loader's concurrent build, and that no module of the port
imports JAX or the JAX package."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_acir_prover.acir import codec as jcodec
from tpu_acir_prover.acir import ir as jir
from tpu_acir_prover.acir.translator import translate_program as jtranslate
from tpu_acir_prover.circuit.compile import compile_circuit as jcompile
from tpu_acir_prover.circuit.compile import powers_u64 as jpowers_u64
from tpu_acir_prover.field import ext as jext
from tpu_acir_prover.field import gl as jgl
from tpu_acir_prover.field import poseidon as jpz
from tpu_acir_prover.prover import compress as jcompress
from tpu_acir_prover.prover import serialization as jser
from tpu_acir_prover.prover import verify as jverify
from tpu_acir_prover.prover.config import TEST_CONFIG as JTEST_CONFIG
from tpu_acir_prover.prover.prove import ProvingKey as OracleKey
from tpu_acir_prover.prover.prove import prove as oracle_prove
from tpu_acir_prover.utils.bench_circuits import \
    mul_chain_circuit as j_mul_chain_circuit
from tpu_acir_prover_torch import native
from tpu_acir_prover_torch.acir import codec
from tpu_acir_prover_torch.acir.translator import translate_program
from tpu_acir_prover_torch.circuit.compile import compile_circuit, powers_u64
from tpu_acir_prover_torch.field import ext
from tpu_acir_prover_torch.field import gl
from tpu_acir_prover_torch.field import poseidon as pz
from tpu_acir_prover_torch.field.gl_np import make_gl
from tpu_acir_prover_torch.prover import compress, serialization
from tpu_acir_prover_torch.prover import verify as pverify
from tpu_acir_prover_torch.utils import circuits
from tpu_acir_prover_torch.utils.bench_circuits import mul_chain_circuit

import factories

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jgl.P


def _u64(seed, n=300):
    v = np.random.default_rng(seed).integers(0, P, size=n, dtype=np.uint64)
    edges = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63],
                     dtype=np.uint64)
    return np.concatenate([v, edges, edges[::-1]])


def test_field_scalars_and_constants_match():
    for name in ("P", "EPSILON", "TWO_ADICITY", "MULTIPLICATIVE_GENERATOR",
                 "POWER_OF_TWO_GENERATOR"):
        assert getattr(gl, name) == getattr(jgl, name), name
    xs = [int(v) for v in _u64(1, 20)]
    for a, b in zip(xs, xs[::-1]):
        for op in ("s_add", "s_sub", "s_mul", "s_pow"):
            assert getattr(gl, op)(a, b) == getattr(jgl, op)(a, b), op
        if a:
            assert gl.s_inv(a) == jgl.s_inv(a)
    for k in range(gl.TWO_ADICITY + 1):
        assert gl.root_of_unity(k) == jgl.root_of_unity(k)
    assert np.array_equal(powers_u64(7, 300), jpowers_u64(7, 300))
    pairs = list(zip(xs, xs[3:] + xs[:3]))
    for x, y in zip(pairs, pairs[::-1]):
        for op in ("e_add", "e_sub", "e_mul"):
            assert getattr(ext, op)(x, y) == getattr(jext, op)(x, y), op
        assert ext.e_pow(x, 12345) == jext.e_pow(x, 12345)
        if x != (0, 0):
            assert ext.e_inv(x) == jext.e_inv(x)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "inv"])
def test_numpy_limb_namespace_matches(op):
    G, J = make_gl(np), jgl.make_gl(np)
    a, b = _u64(2), _u64(3)
    a[a == 0] = 1  # inv of 0 is undefined
    args = (G.from_u64(a), G.from_u64(b))[:1 if op in ("neg", "inv") else 2]
    jargs = (J.from_u64(a), J.from_u64(b))[:len(args)]
    assert np.array_equal(G.to_u64(getattr(G, op)(*args)),
                          J.to_u64(getattr(J, op)(*jargs)))


def test_poseidon_constants_and_int_permutation_match():
    for name in ("ROUND_CONSTANTS", "INTERNAL_CONSTANTS", "DIAG", "DIAG_M1"):
        assert np.array_equal(getattr(pz, name), getattr(jpz, name)), name
    for seed in range(4):
        st = [int(v) for v in _u64(seed, 12)[:12]]
        assert pz.permute_ints(st) == jpz.permute_ints(st)
        assert pz.hash_no_pad_ints(st[:9]) == jpz.hash_no_pad_ints(st[:9])
        assert pz.two_to_one_ints(st[:4], st[4:8]) == \
            jpz.two_to_one_ints(st[:4], st[4:8])


def _port_program(prog):
    """A JAX-package program rebuilt by the port's codec from its bytes."""
    return codec.deserialize_program(jcodec.serialize_program(prog))


@pytest.mark.parametrize("name", sorted(factories.ALL_SMALL))
def test_codec_bytes_match(name, tmp_path):
    prog, wm = factories.ALL_SMALL[name]()
    data = jcodec.serialize_program(prog)
    assert codec.serialize_program(_port_program(prog)) == data
    jcodec.save_program_artifact(str(tmp_path / "j.json"), prog)
    codec.save_program_artifact(str(tmp_path / "p.json"),
                                codec.load_program_artifact(
                                    str(tmp_path / "j.json")))
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    jcodec.save_witness_stack(str(tmp_path / "j.gz"),
                              jir.WitnessStack([jir.StackItem(0, wm)]))
    ws = codec.load_witness_stack(str(tmp_path / "j.gz"))
    codec.save_witness_stack(str(tmp_path / "p.gz"), ws)
    assert (tmp_path / "p.gz").read_bytes() == (tmp_path / "j.gz").read_bytes()


@pytest.mark.parametrize("name", sorted(factories.ALL_SMALL))
def test_translate_and_compile_match(name):
    prog, wm = factories.ALL_SMALL[name]()
    jtr = jtranslate(prog)
    jcc = jcompile(jtr.builder)
    tr = translate_program(_port_program(prog))
    cc = compile_circuit(tr.builder)
    assert (cc.n, cc.num_vars, cc.k_shifts, cc.lookup_bits) == \
        (jcc.n, jcc.num_vars, jcc.k_shifts, jcc.lookup_bits)
    for f in ("selectors", "wire_vars", "sigma", "external_vars",
              "public_input_vars"):
        assert np.array_equal(getattr(cc, f), getattr(jcc, f)), f
    ext_vals = tr.external_values(wm)
    assert np.array_equal(ext_vals, jtr.external_values(wm))
    # the port's native witness core against the JAX package's witness
    # generation (its native core or, where that did not load, its numpy
    # fallback: the two are held equal in tests/test_structural.py)
    assert native.get_lib() is not None
    vals = cc.generate_witness(ext_vals)
    assert np.array_equal(vals, jcc.generate_witness(ext_vals))
    assert cc.check_constraints(vals) is None


@pytest.mark.parametrize("log_n", [4, 9])
def test_bench_circuits_match(log_n):
    got, want = mul_chain_circuit(log_n), j_mul_chain_circuit(log_n)
    for f in ("n", "log_n", "num_vars", "k_shifts", "num_public_inputs",
              "lookup_bits"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("selectors", "wire_vars", "sigma", "external_vars",
              "public_input_vars"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert len(got.gen_batches) == len(want.gen_batches)
    for a, b in zip(got.gen_batches, want.gen_batches):
        assert a.op == b.op
        for f in ("out", "a", "b", "const"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(got.generate_witness(np.array([], np.uint64)),
                          want.generate_witness(np.array([], np.uint64)))


@pytest.mark.parametrize("name", ["fibonacci", "ecdsa_secp256k1",
                                  "sha256_multiblock"])
def test_circuits_match_factories(name):
    """Program bytes only: compiling the ECDSA circuit would not fit the
    tests' time budget.  The heavy programs come from the two ``ALL_HEAVY``
    registries, which name the same programs."""
    assert sorted(circuits.ALL_HEAVY) == sorted(factories.ALL_HEAVY)
    factory = factories.ALL_HEAVY.get(name, getattr(factories, name))
    prog, wm = circuits.ALL_HEAVY.get(name, getattr(circuits, name))()
    jprog, jwm = factory()
    assert codec.serialize_program(prog) == jcodec.serialize_program(jprog)
    assert wm == jwm


@pytest.mark.parametrize("name", sorted(factories.ALL_SMALL))
def test_example_builders_match_factories(name):
    """Each copied example builder gives its original's program bytes and
    witness map."""
    prog, wm = circuits.ALL_SMALL[name]()
    jprog, jwm = factories.ALL_SMALL[name]()
    assert codec.serialize_program(prog) == jcodec.serialize_program(jprog)
    assert wm == jwm


def _honest_proof():
    prog, wm = factories.fibonacci()
    tr = jtranslate(prog)
    pk = OracleKey(jcompile(tr.builder), JTEST_CONFIG, xp=np)
    proof = oracle_prove(pk, tr.external_values(wm))
    return pk.vk, proof


def _outcome(verify, vk, proof):
    try:
        verify(vk, proof)
    except Exception as e:  # any failure is a rejection
        return type(e).__name__
    return "accept"


def test_verifier_agrees_with_jax():
    vk, proof = _honest_proof()
    vk_bytes, data = jser.serialize_vk(vk), jser.serialize_proof(proof)
    pvk = serialization.deserialize_vk(vk_bytes)
    assert serialization.serialize_vk(pvk) == vk_bytes
    assert _outcome(pverify.verify, pvk,
                    serialization.deserialize_proof(data)) == "accept"
    positions = np.random.default_rng(5).choice(len(data), 40, replace=False)
    rejected = 0
    for pos in sorted(int(p) for p in positions) + [len(data) - 1]:
        bad = bytearray(data)
        bad[pos] ^= 0x01
        try:
            jproof = jser.deserialize_proof(bytes(bad))
        except Exception as e:
            with pytest.raises(type(e)):
                serialization.deserialize_proof(bytes(bad))
            rejected += 1
            continue
        want = _outcome(jverify.verify, vk, jproof)
        got = _outcome(pverify.verify, pvk,
                       serialization.deserialize_proof(bytes(bad)))
        assert got == want, pos
        rejected += want != "accept"
    assert rejected > 30


def test_compress_and_serialization_round_trips_match():
    vk, proof = _honest_proof()
    data = jser.serialize_proof(proof)
    pvk = serialization.deserialize_vk(jser.serialize_vk(vk))
    pproof = serialization.deserialize_proof(data)
    assert serialization.serialize_proof(pproof) == data
    cdata = jser.serialize_compressed_proof(jcompress.compress_proof(vk, proof))
    assert serialization.serialize_compressed_proof(
        compress.compress_proof(pvk, pproof)) == cdata
    back = compress.decompress_proof(
        pvk, serialization.deserialize_compressed_proof(cdata))
    assert serialization.serialize_proof(back) == data
    pverify.verify(pvk, back)


_BUILD = r"""
import ctypes, sys
from tpu_acir_prover_torch.native import build_lib
lib = ctypes.CDLL(build_lib(sys.argv[1]))
assert lib.gl_run_ops
print("LOADED")
"""


def test_native_library_builds_in_two_processes_at_once(tmp_path):
    """Both processes compile into the same empty directory; each renames
    its own temporary file into place, so both load a whole library."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert "LOADED" in out
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 1 and names[0].endswith(".so"), names


def _sources():
    pkg = os.path.join(ROOT, "tpu_acir_prover_torch")
    for d, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    for script in ("chip_smoke.py", "bench_torch.py",
                   "examples/run_examples_torch.py"):
        yield os.path.join(ROOT, script)


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "tpu_acir_prover")
    found = []
    checked = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in ("mesh", "pipeline", "fri", "prove"):
        assert f"tpu_acir_prover_torch/parallel/{mod}.py" in checked, mod
    assert "tpu_acir_prover_torch/utils/bench_circuits.py" in checked
    for path in ("tpu_acir_prover_torch/parallel/scaling.py",
                 "bench_torch.py", "examples/run_examples_torch.py"):
        assert path in checked, path
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] in banned]
    assert not found, found
