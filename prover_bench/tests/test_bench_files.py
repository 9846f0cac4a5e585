"""BENCHMARK.json and the files it names: names and units in the allowed
characters, every per-layer metric moving one end-to-end metric that each
of its cells reports, a reader for every metric, the families' files, and
a configuration picked up from an added file alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from prover_bench import harness, metrics, programs, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "prover_bench/run.py"]
    assert BENCH["paths"] == ["prover_bench"]
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] +
                         ALL_METRICS, ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in TEXT_KEYS:
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_cell_reports(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert cell in {w["name"] for w in BENCH["workloads"]}
        assert _reports(cell, e2e[metric["moves"]])


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(metrics.load(metric["name"]).read)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert cell["chips"] in (1, 4)
    c = harness.load_cell(ROOT, cell["name"])
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert callable(programs.load(c.config["program"]).build)
    assert c.traffic["warmup_proofs"] >= 1


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert path.is_relative_to(ROOT / "prover_bench")
    data = json.loads(path.read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert set(data["proof_config"]) == {"rate_bits", "cap_height",
                                         "num_queries", "pow_bits",
                                         "final_poly_domain"}


def test_families():
    fams = trace.load_families(ROOT)
    assert {"merkle", "field"} <= set(fams)
    counters = [c for f in fams.values() for c in f.values()]
    assert len(counters) == len(set(counters))
    for path in (ROOT / "prover_bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_.-]+$", path.name), path


def test_kernel_names():
    assert trace.kernel_name(
        "void gl_binary_kernel<2, 1>(unsigned long const*, long)") == \
        "gl_binary_kernel"
    assert trace.kernel_name("leaf_hash_kernel(unsigned long const*, long)") \
        == "leaf_hash_kernel"
    assert trace.kernel_name("_Z16leaf_hash_kernelPKmlii") == \
        "leaf_hash_kernel"
    assert trace.kernel_name("_Z16gl_binary_kernelILi2ELi1EEvPKmS1_Pm") == \
        "gl_binary_kernel"
    assert trace.kernel_name("_ZN12_GLOBAL__N_116leaf_hash_kernelEPKmlii") \
        == "leaf_hash_kernel"
    assert trace.kernel_name(
        "void (anonymous namespace)::ext_prod_kernel<true>(GroupArgs, "
        "unsigned long*, unsigned int)") == "ext_prod_kernel"
    assert trace.kernel_name(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::(anonymous namespace)::FillFunctor<long>>(int)") == \
        "at::native::vectorized_elementwise_kernel"


def test_added_configuration_is_found(tmp_path):
    """A later PR adds a configuration by adding its file and the entries
    that name it: the harness finds it by name, with no code edited."""
    shutil.copytree(ROOT / "prover_bench" / "traffic",
                    tmp_path / "prover_bench" / "traffic")
    conf = {"name": "sha256_short", "program": "sha256", "message_bytes": 55,
            "proof_config": {"rate_bits": 3, "cap_height": 4,
                             "num_queries": 28, "pow_bits": 16,
                             "final_poly_domain": 256},
        "source": "x", "reduced": []}
    (tmp_path / "prover_bench" / "configs").mkdir()
    (tmp_path / "prover_bench" / "configs" / "sha256_short.json") \
        .write_text(json.dumps(conf))
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [
        {"name": "sha256_short", "source": "x", "reduced": [], "why": "x",
         "file": "prover_bench/configs/sha256_short.json"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "sha256_short.single", "config": "sha256_short",
         "traffic": "single", "chips": 1, "why": "x"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "sha256_short.single")
    assert cell.config == conf
    prog = programs.load(cell.config["program"]).build(cell.config)
    assert len(prog.functions[0].opcodes) == 1
