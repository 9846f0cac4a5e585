"""The reference against small CPU proofs made by ``api.prove_file``: it
derives the verifying key the program writes and the wire commitment of
each proof from its witness file alone, accepts the proof and rejects it
with one byte flipped; its plain witness solve gives the port's wires; and
the Merkle work count equals the leaves and trees the port hashes in a
proof."""

import random
from collections import Counter

import pytest

from prover_bench import reference, roofline
from prover_bench.frozen.acir import codec, ir
from prover_bench.programs import load
from tpu_acir_prover_torch import api
from tpu_acir_prover_torch.kernels import poseidon as kp

CFG = {"steps": 40,
       "proof_config": {"rate_bits": 3, "cap_height": 1, "num_queries": 8,
                        "pow_bits": 4, "final_poly_domain": 64}}


def _inputs(tmp_path, seed):
    prog = load("square_chain")
    art, wit = str(tmp_path / "p.json"), str(tmp_path / "w.gz")
    codec.save_program_artifact(art, prog.build(CFG))
    inputs = prog.draw(CFG, random.Random(seed))
    codec.save_witness_stack(wit, ir.WitnessStack(
        [ir.StackItem(0, prog.witness(CFG, inputs))]))
    return art, wit


@pytest.fixture(scope="module")
def proven(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("proof")
    art, wit = _inputs(tmp, 2 ** 33 + 3)
    cfg = reference.proof_config(CFG)
    out, vk_path = str(tmp / "proof.bin"), str(tmp / "vk.bin")
    api.prove_file(art, wit, out, cfg, "cpu")
    api.write_vk_file(art, vk_path, cfg, "cpu")
    api._CACHE.clear()
    circuit = reference.load_circuit(art)
    with open(out, "rb") as f, open(vk_path, "rb") as g:
        return (art, f.read(), g.read(),
                reference.derive_vk(circuit, cfg, "cpu"),
                reference.wires_cap(circuit, wit, cfg, "cpu"))


def test_reference_derives_the_programs_vk(proven):
    _, _, vk_bytes, vk, _ = proven
    assert reference.vk_bytes(vk) == vk_bytes
    assert vk.num_public_inputs == 1


def test_reference_accepts_the_proof(proven):
    _, data, _, vk, _ = proven
    assert reference.judge_proof(vk, data) == ""


def test_reference_derives_the_proofs_wire_commitment(proven, tmp_path):
    """The wire commitment worked out from the witness file is the proof's,
    and that of another witness of the same program is not."""
    art, data, _, _, own = proven
    assert reference.proof_wires_cap(data) == own
    _, other = _inputs(tmp_path, 2 ** 33 + 4)
    cfg = reference.proof_config(CFG)
    assert reference.wires_cap(reference.load_circuit(art), other, cfg,
                               "cpu") != own
    assert reference.proof_wires_cap(b"\0" * 16) is None


@pytest.mark.parametrize("name,cfg", [
    ("square_chain", {"steps": 40}), ("sha256", {"message_bytes": 20})])
def test_reference_solve_gives_the_ports_wires(tmp_path, name, cfg):
    """The reference's plain solve of the generators and its wire routing
    give the wire matrix of the port's compiled circuit and witness fill."""
    from tpu_acir_prover_torch.acir import codec as port_codec
    from tpu_acir_prover_torch.acir.translator import translate_program
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    prog = load(name)
    art = str(tmp_path / "p.json")
    codec.save_program_artifact(art, prog.build(cfg))
    wm = prog.witness(cfg, prog.draw(cfg, random.Random(2 ** 33 + 9)))
    circuit = reference.load_circuit(art)
    mine = reference.wire_columns(circuit, reference.solve(circuit, wm))
    tr = translate_program(port_codec.load_program_artifact(art))
    cc = compile_circuit(tr.builder)
    vals = cc.generate_witness(tr.external_values(wm))
    assert cc.check_constraints(vals) is None
    assert (mine == cc.wire_values(vals)).all()


@pytest.mark.parametrize("where", [0.1, 0.3, 0.5, 0.7, 0.95])
def test_reference_rejects_a_flipped_byte(proven, where):
    _, data, _, vk, _ = proven
    i = int(len(data) * where)
    bad = data[:i] + bytes([data[i] ^ 0x10]) + data[i + 1:]
    assert reference.judge_proof(vk, bad) != ""


def test_reference_rejects_weaker_proof_of_work(proven, tmp_path):
    """A proof ground to fewer bits than the key states fails where its
    nonce's challenge misses the stated bits (the harness's control)."""
    art, _, _, vk, _ = proven
    weak = reference.proof_config(
        {"proof_config": {**CFG["proof_config"], "pow_bits": 1}})
    misses = 0
    for seed in range(6):
        a, w = _inputs(tmp_path, seed)
        out = str(tmp_path / f"weak{seed}.bin")
        api.prove_file(a, w, out, weak, "cpu")
        with open(out, "rb") as f:
            misses += reference.judge_proof(vk, f.read()) != ""
    api._CACHE.clear()
    assert misses >= 1


def _children():
    """Process ids of this process's live children (Linux)."""
    import glob
    kids = set()
    for f in glob.glob("/proc/self/task/*/children"):
        with open(f) as fh:
            kids.update(int(x) for x in fh.read().split())
    return kids


def test_judging_workers_keep_order_and_leave_no_process(proven, tmp_path,
                                                         monkeypatch):
    """The verdicts come back in the files' order from several workers, a
    worker that ends without its verdicts rejects its files, and no child
    process of the run outlives the call."""
    _, data, _, vk, _ = proven
    bad = data[:100] + bytes([data[100] ^ 0x10]) + data[101:]
    paths = []
    for i, d in enumerate([data, bad, data, bad, data]):
        paths.append(str(tmp_path / f"p{i}.bin"))
        with open(paths[-1], "wb") as f:
            f.write(d)
    monkeypatch.setattr(reference.os, "cpu_count", lambda: 4)
    before = _children()
    verdicts, other = reference.judge_files(vk, paths, lambda: "meanwhile")
    assert other == "meanwhile"
    assert [v == "" for v in verdicts] == [True, False, True, False, True]
    assert _children() <= before
    monkeypatch.setattr(reference.sys, "executable", "false")
    verdicts, _ = reference.judge_files(vk, paths[:2])
    assert all("without a verdict" in v for v in verdicts)
    assert _children() <= before


@pytest.mark.parametrize("fused", ["0", "1"])
def test_merkle_work_is_what_the_port_hashes(tmp_path, monkeypatch, fused):
    art, wit = _inputs(tmp_path, 11)
    cfg = reference.proof_config(CFG)
    monkeypatch.setenv("TPU_ACIR_FUSED", fused)
    _, pk = api.load_and_compile(art, cfg, "cpu")  # the key's own commit
    seen = Counter()
    leaf, levels = kp.leaf_hash, kp.two_to_one_levels

    def spy_leaf(m):
        seen["leaves", m.shape[0], m.shape[1]] += 1
        return leaf(m)

    def spy_levels(child, n):
        seen["tree", child.shape[0], child.shape[0] >> n] += 1
        return levels(child, n)

    monkeypatch.setattr(kp, "leaf_hash", spy_leaf)
    monkeypatch.setattr(kp, "two_to_one_levels", spy_levels)
    api.prove_file(art, wit, str(tmp_path / "p.bin"), cfg, "cpu")
    api._CACHE.clear()
    want = Counter((h.kind, h.rows, h.cols if h.kind == "leaves" else h.cap)
                   for h in roofline.merkle_work(pk.vk) if h.permutations)
    assert seen == want
    assert roofline.least_s(roofline.merkle_work(pk.vk)) > 0


def test_merkle_work_of_the_cells():
    """The count at the cells' sizes, from their verifying keys' widths."""
    from prover_bench.frozen.prover.proof import VerifyingKey
    vk = VerifyingKey(log_n=17, num_wires=16, num_public_inputs=0,
                      k_shifts=(), num_quotient_chunks=6, rate_bits=3,
                      cap_height=4, num_queries=28, pow_bits=16,
                      final_poly_domain=256, lookup_bits=16)
    work = roofline.merkle_work(vk)
    leaves = [h for h in work if h.kind == "leaves"]
    # wires + multiplicity, 3 permutation + 4 lookup + 2 ext columns, the
    # quotient's 12, then 12 FRI layers 2^19 .. 2^8 leaves
    assert [(h.rows, h.cols) for h in leaves[:3]] == \
        [(1 << 20, 17), (1 << 20, 18), (1 << 20, 12)]
    assert [h.rows for h in leaves[3:]] == [1 << k for k in range(19, 7, -1)]
