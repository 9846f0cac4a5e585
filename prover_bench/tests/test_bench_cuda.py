"""The harness and the reference on the card (``cuda`` marker; each test
skips where no card is present): a traced run of a few-row program whose
profiler sees every launch the counters hold, the control not correct, and
the reference's preprocessed and wire commitments in plain torch on the
card equal to the key and the proof the program makes there for the
``sha256_long`` configuration."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from prover_bench import harness, reference
from prover_bench.frozen.acir import codec
from prover_bench.programs import load

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 202
TINY = {"name": "tiny", "program": "square_chain", "steps": 300,
        "proof_config": {"rate_bits": 3, "cap_height": 4, "num_queries": 28,
                         "pow_bits": 16, "final_poly_domain": 256},
        "source": "x", "reduced": []}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("root")
    for sub in ("traffic", "families"):
        shutil.copytree(ROOT / "prover_bench" / sub, tmp / "prover_bench" / sub)
    (tmp / "prover_bench" / "configs").mkdir()
    (tmp / "prover_bench" / "configs" / "tiny.json").write_text(
        json.dumps(TINY))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "x", "reduced": [],
                         "why": "x", "file": "prover_bench/configs/tiny.json"}]
    bench["workloads"] = [{"name": f"tiny.{t}", "config": "tiny",
                           "traffic": t, "chips": 1, "why": "x"}
                          for t in ("single", "per_phase")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.mark.parametrize("workload", ["tiny.single", "tiny.per_phase"])
def test_traced_run_on_the_card(card, root, workload):
    from tpu_acir_prover_torch import api
    api._CACHE.clear()
    line = harness.run(root, workload, SEED, 2.0, True)
    assert line["correct"], line["compared"]
    assert line["device"]["busy_s"] > 0
    assert "merkle_roofline_pct" in line["metrics"]
    assert 0 < line["metrics"]["merkle_roofline_pct"]["value"] <= 105


def test_control_on_the_card(card, root):
    from tpu_acir_prover_torch import api
    api._CACHE.clear()
    line = harness.run(root, "tiny.single", SEED, 2.0, False, control=True)
    assert not line["correct"]


def test_reference_commitments_of_sha256_long(card, tmp_path):
    import random
    from prover_bench.frozen.acir import ir
    from tpu_acir_prover_torch import api
    conf = json.loads((ROOT / "prover_bench" / "configs" /
                       "sha256_long.json").read_text())
    cfg = reference.proof_config(conf)
    prog = load(conf["program"])
    art, wit = str(tmp_path / "p.json"), str(tmp_path / "w.gz")
    vk_path, out = str(tmp_path / "vk.bin"), str(tmp_path / "proof.bin")
    codec.save_program_artifact(art, prog.build(conf))
    codec.save_witness_stack(wit, ir.WitnessStack([ir.StackItem(
        0, prog.witness(conf, prog.draw(conf, random.Random(SEED))))]))
    api.prove_file(art, wit, out, cfg, "cuda")
    api.write_vk_file(art, vk_path, cfg, "cuda")
    api._CACHE.clear()
    torch.cuda.empty_cache()
    circuit = reference.load_circuit(art)
    vk = reference.derive_vk(circuit, cfg, "cuda")
    with open(vk_path, "rb") as f:
        assert f.read() == reference.vk_bytes(vk)
    with open(out, "rb") as f:
        data = f.read()
    assert reference.proof_wires_cap(data) == \
        reference.wires_cap(circuit, wit, cfg, "cuda")
    assert reference.judge_proof(vk, data) == ""
    assert vk.log_n == 18 and vk.lookup_bits == 0
