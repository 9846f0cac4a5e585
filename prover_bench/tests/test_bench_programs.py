"""The frozen generators write the programs and witnesses of the port's
``utils/circuits.py``: their artifact and witness bytes decode through the
port's codec to the same circuits (SHA-256 at 1 and 5 blocks) and witness
maps; the outputs they write are the plain reference's."""

import hashlib
import random
import struct

import pytest

from prover_bench.frozen.acir import codec, ir
from prover_bench.programs import load, sha256
from tpu_acir_prover_torch.acir import codec as port_codec
from tpu_acir_prover_torch.utils import circuits

SEED = 0x1234


def _files(tmp_path, program, wm):
    art, wit = str(tmp_path / "p.json"), str(tmp_path / "w.gz")
    codec.save_program_artifact(art, program)
    codec.save_witness_stack(wit, ir.WitnessStack([ir.StackItem(0, wm)]))
    return (port_codec.load_program_artifact(art),
            port_codec.load_witness_stack(wit).peek().witness)


@pytest.mark.parametrize("blocks", [1, 5])
def test_sha256_blocks_decode_to_the_ports_circuit(tmp_path, blocks):
    words = [[(SEED * (b * 16 + i + 1) * 2654435761) & 0xFFFFFFFF
              for i in range(16)] for b in range(blocks)]
    prog, wm = _files(tmp_path, sha256.program_for_blocks(blocks),
                      sha256.witness_for_blocks(words))
    want_prog, want_wm = circuits.sha256_multiblock(blocks, seed=SEED)
    assert port_codec.serialize_program(prog) == \
        port_codec.serialize_program(want_prog)
    assert wm == want_wm


def test_sha256_long_is_five_blocks_and_its_digest():
    cfg = {"message_bytes": 250}
    assert len(sha256.build(cfg).functions[0].opcodes) == 5
    inputs = sha256.draw(cfg, random.Random(2 ** 33 + 1))
    wm = sha256.witness(cfg, inputs)
    digest = struct.unpack(">8I", hashlib.sha256(
        bytes.fromhex(inputs["message"])).digest())
    assert [wm[8 + 24 * 4 + 16 + i] for i in range(8)] == list(digest)
    assert sha256.check(cfg, inputs, wm) == 0
    wm[8 + 24 * 4 + 16] ^= 1
    assert sha256.check(cfg, inputs, wm) == 1


@pytest.mark.parametrize("name,cfg", [
    ("sha256", {"message_bytes": 250}), ("square_chain", {"steps": 8}),
    ("ecdsa", {})])
def test_draws_follow_the_seed(name, cfg):
    prog = load(name)
    a = [prog.draw(cfg, random.Random(2 ** 32 + 7)) for _ in range(2)]
    b = [prog.draw(cfg, random.Random(2 ** 32 + 7)) for _ in range(2)]
    assert a == b
    rng = random.Random(2 ** 32 + 7)
    two = [prog.draw(cfg, rng) for _ in range(2)]
    assert two[0] != two[1]
    for inputs in two:
        assert prog.check(cfg, inputs, prog.witness(cfg, inputs)) == 0
