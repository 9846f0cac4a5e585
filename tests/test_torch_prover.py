"""Port NTT, Merkle trees, proving key, prover, api and CLI against the JAX
package's numpy backend, bit for bit: LDE values, caps and paths,
``vk.constants_cap`` and the ``serialize_proof`` bytes.  The port runs on
``device="cpu"``, where its kernel wrappers take the plain twins."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_acir_prover.acir import codec, ir
from tpu_acir_prover.acir.translator import translate_program
from tpu_acir_prover.circuit.builder import CircuitBuilder
from tpu_acir_prover.circuit.compile import compile_circuit
from tpu_acir_prover.field.gl import P, make_gl
from tpu_acir_prover.field.poseidon import make_poseidon
from tpu_acir_prover.prover import ntt as jntt
from tpu_acir_prover.prover.config import TEST_CONFIG
from tpu_acir_prover.prover.merkle import merkle_commit, verify_merkle_path
from tpu_acir_prover.prover.prove import ProvingKey as OracleKey
from tpu_acir_prover.prover.prove import prove as oracle_prove
from tpu_acir_prover.prover.serialization import serialize_proof
from tpu_acir_prover.prover.verify import verify
from tpu_acir_prover_torch import cli
from tpu_acir_prover_torch.field import gl
from tpu_acir_prover_torch.prover import ntt
from tpu_acir_prover_torch.prover.merkle import merkle_tree
from tpu_acir_prover_torch.prover.prove import ProvingKey, prove

import factories

torch.set_num_threads(1)

G = make_gl(np)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _jax_u64(pair):
    return np.asarray(G.to_u64(pair))


@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_intt_coset_lde_match_numpy(log_n):
    v = _rand((1 << log_n, 3), seed=log_n)
    t = gl.from_u64(v, "cpu")
    pair = G.from_u64(v)
    assert np.array_equal(gl.to_u64(ntt.ntt(t)), _jax_u64(jntt.ntt(G, pair)))
    assert np.array_equal(gl.to_u64(ntt.intt(t)),
                          _jax_u64(jntt.intt(G, pair)))
    assert np.array_equal(gl.to_u64(ntt.coset_lde(t, 2)),
                          _jax_u64(jntt.coset_lde(G, pair, 2)))
    assert np.array_equal(gl.to_u64(ntt.coset_intt(t)),
                          _jax_u64(jntt.coset_intt(G, pair)))


@pytest.mark.parametrize("cap_height", [0, 2, 6])
def test_merkle_caps_and_paths_match(cap_height):
    m = _rand((64, 5), seed=cap_height)
    ref = merkle_commit(G, make_poseidon(G), G.from_u64(m), cap_height)
    tree = merkle_tree(gl.from_u64(m, "cpu"), cap_height)
    cap = tree.cap_u64()
    assert np.array_equal(cap, ref.cap_u64())
    idx = [0, 5, 63, 32, 5]
    rows, paths = tree.rows_and_paths(idx)
    ref_rows, ref_paths = ref.rows_and_paths(idx)
    assert np.array_equal(rows, ref_rows)
    for q, i in enumerate(idx):
        assert len(paths[q]) == len(ref_paths[q]) == 6 - cap_height
        for a, b in zip(paths[q], ref_paths[q]):
            assert np.array_equal(a, b)
        assert verify_merkle_path(rows[q], i, paths[q], cap)


def _mul_circuit():
    b = CircuitBuilder()
    x = b.add_external()
    y = b.add_external()
    b.register_public_input(x)
    s = b.lincomb([(2, b.mul(y, y)), (3, y)], 1)
    b.assert_equal(s, x)
    return b, [2 * 25 + 3 * 5 + 1, 5]


def _lookup_circuit():
    b = CircuitBuilder(lookup_bits=8)
    x = b.add_external()
    b.range_check(x, 8)
    y = b.add_external()
    b.range_check(y, 5)
    z = b.add_external()
    b.range_check(z, 19)
    return b, [200, 31, (1 << 19) - 3]


@pytest.mark.parametrize("make", [_mul_circuit, _lookup_circuit],
                         ids=["mul", "lookup_bits8"])
def test_proof_bytes_match_numpy_prover(make):
    b, ext = make()
    cc = compile_circuit(b)
    ext = np.array(ext, dtype=np.uint64)
    ref_pk = OracleKey(cc, TEST_CONFIG, xp=np)
    pk = ProvingKey(cc, TEST_CONFIG, device="cpu")
    assert pk.vk.constants_cap == ref_pk.vk.constants_cap
    proof = prove(pk, ext, check_constraints=True)
    verify(pk.vk, proof)
    assert serialize_proof(proof) == serialize_proof(oracle_prove(ref_pk, ext))


def _write_fibonacci(tmp_path):
    prog, wm = factories.fibonacci()
    prog_path, wit_path = tmp_path / "prog.json", tmp_path / "witness.gz"
    codec.save_program_artifact(str(prog_path), prog)
    codec.save_witness_stack(str(wit_path),
                             ir.WitnessStack([ir.StackItem(0, wm)]))
    return str(prog_path), str(wit_path)


def test_cli_round_trip_and_tamper(tmp_path):
    prog, wit = _write_fibonacci(tmp_path)
    proof, vk = str(tmp_path / "proof"), str(tmp_path / "vk")
    flags = ["--test-config", "--device", "cpu"]
    assert cli.main(["prove", "-b", prog, "-w", wit, "-o", proof, *flags]) == 0
    assert cli.main(["write_vk", "-b", prog, "-o", vk, *flags]) == 0
    assert cli.main(["verify", "-k", vk, "-p", proof]) == 0
    data = bytearray(open(proof, "rb").read())
    data[len(data) // 2] ^= 1
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    assert cli.main(["verify", "-k", vk, "-p", str(bad)]) == 1


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prog, wit = _write_fibonacci(tmp_path)
    tr = translate_program(codec.load_program_artifact(prog))
    with pytest.raises(RuntimeError, match="cuda"):
        ProvingKey(compile_circuit(tr.builder), TEST_CONFIG, device="cuda")
    assert cli.main(["prove", "-b", prog, "-w", wit, "-o",
                     str(tmp_path / "p"), "--test-config"]) == 1
    assert not (tmp_path / "p").exists()


_JAX_FREE = r"""
import sys
sys.modules["jax"] = None
sys.modules["tpu_acir_prover"] = None
from tpu_acir_prover_torch import api
from tpu_acir_prover_torch.acir import codec, ir
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.utils import circuits
prog, wm = circuits.fibonacci()
codec.save_program_artifact(sys.argv[1] + "/prog.json", prog)
codec.save_witness_stack(sys.argv[1] + "/w.gz",
                         ir.WitnessStack([ir.StackItem(0, wm)]))
api.prove_file(sys.argv[1] + "/prog.json", sys.argv[1] + "/w.gz",
               sys.argv[1] + "/proof", TEST_CONFIG, device="cpu")
api.write_vk_file(sys.argv[1] + "/prog.json", sys.argv[1] + "/vk",
                  TEST_CONFIG, device="cpu")
api.verify_file(sys.argv[1] + "/vk", sys.argv[1] + "/proof")
loaded = [k for k, v in sys.modules.items() if v is not None and
          k.split(".")[0] in ("jax", "jaxlib", "tpu_acir_prover")]
assert not loaded, loaded
print("JAX-FREE OK")
"""


def test_port_proves_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _JAX_FREE, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX-FREE OK" in res.stdout
