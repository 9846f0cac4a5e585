"""Shared by ``tests/test_torch_examples.py`` and
``tests/test_torch_examples_lookup.py``: the port's CLI on one small
example program against the JAX package's numpy CLI path, bit for bit (the
compressed proof bytes and the vk bytes, both at the test config); the
port's verifier accepts the proof and rejects it with a byte flipped.  The
artifact and witness are written as ``examples/run_examples_torch.py``
writes them, with the port's codec and its copies of the example
builders."""

import importlib.util
import os

from tpu_acir_prover import api as japi
from tpu_acir_prover.prover.config import TEST_CONFIG
from tpu_acir_prover_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the examples whose circuits have a lookup table or a memory block; the
# others are plain arithmetic
LOOKUP = ("and_8", "array_dynamic", "memory_read", "memory_write", "range_8",
          "range_33", "xor_32")


def _driver():
    spec = importlib.util.spec_from_file_location(
        "run_examples_torch",
        os.path.join(ROOT, "examples", "run_examples_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example(name, tmp_path):
    bc, wit = _driver().write_example(name, str(tmp_path))
    proof, vk = str(tmp_path / "proof"), str(tmp_path / "vk")
    flags = ["--device", "cpu", "--test-config"]
    assert cli.main(["prove", "-b", bc, "-w", wit, "-o", proof, *flags]) == 0
    assert cli.main(["write_vk", "-b", bc, "-o", vk, *flags]) == 0
    want_proof = japi.prove_file(bc, wit, str(tmp_path / "jproof"),
                                 TEST_CONFIG, backend="numpy")
    want_vk = japi.write_vk_file(bc, str(tmp_path / "jvk"), TEST_CONFIG,
                                 backend="numpy")
    data = open(proof, "rb").read()
    assert data == want_proof
    assert open(vk, "rb").read() == want_vk
    assert cli.main(["verify", "-k", vk, "-p", proof]) == 0
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 1
    (tmp_path / "bad").write_bytes(bytes(bad))
    assert cli.main(["verify", "-k", vk, "-p", str(tmp_path / "bad")]) == 1
