"""The harness's CPU dry path: a whole run on a few-row program with the
look for a card skipped, ``correct`` true, and no module of JAX or the JAX
package loaded; the control and the faults a proof can have make
``correct`` false; a traced run whose profiler misses launches fails;
the harness's own witness files stay out of ``setup_s``."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from prover_bench import harness, trace
from tpu_acir_prover_torch import api

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 101
TINY = {"name": "tiny", "program": "square_chain", "steps": 20,
        "proof_config": {"rate_bits": 3, "cap_height": 1, "num_queries": 8,
                         "pow_bits": 4, "final_poly_domain": 64},
        "source": "x", "reduced": []}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose BENCHMARK.json holds one few-row configuration
    under each traffic mix."""
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


def _run(root, workload="tiny.per_phase", traced=False, **kw):
    api._CACHE.clear()
    return harness.run(root, workload, SEED, 0.01, traced, device="cpu", **kw)


@pytest.mark.parametrize("workload,traced", [
    ("tiny.single", False), ("tiny.per_phase", True)])
def test_dry_run_is_correct_and_loads_no_jax(root, workload, traced,
                                             monkeypatch):
    line = _run(root, workload, traced)
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = set(line["metrics"])
    if traced:
        assert {"api_other_ms", "witness_fill_ms", "quotient_ms",
                "device_idle_pct"} <= names
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        assert {"proof_s", "proof_p90_s", "setup_s"} <= names
    assert list(line)[-1] == "compared"
    assert harness.forbidden_modules() == []


def test_control_is_not_correct(root):
    """One bit of proof of work fewer than stated: the key the program
    writes differs, and proofs whose nonce misses the stated bits fail."""
    line = _run(root, control=True)
    assert not line["correct"]
    assert line["compared"]["vk_bytes_differ"]["value"] == 1


def test_a_stale_proof_is_not_correct(root, monkeypatch):
    """A step that returns its state unchanged: each proof file is the last
    proof's bytes, not a proof of its own witness."""
    prove, last = api.prove_file, {}

    def stale(bytecode, witness, out, *a, **kw):
        if "data" not in last:
            last["data"] = prove(bytecode, witness, out, *a, **kw)
        with open(out, "wb") as f:
            f.write(last["data"])
        return last["data"]

    monkeypatch.setattr(api, "prove_file", stale)
    line = _run(root)
    assert not line["correct"]
    assert line["compared"]["proofs_repeated"]["value"] >= 1


def test_an_altered_proof_is_not_correct(root, monkeypatch):
    """An answer altered where it is produced: one byte of each proof file
    flipped as the entry writes it."""
    prove = api.prove_file

    def altered(bytecode, witness, out, *a, **kw):
        data = prove(bytecode, witness, out, *a, **kw)
        bad = bytearray(data)
        bad[len(bad) // 2] ^= 0x01
        with open(out, "wb") as f:
            f.write(bad)
        return bytes(bad)

    monkeypatch.setattr(api, "prove_file", altered)
    line = _run(root)
    assert not line["correct"]
    assert line["compared"]["proofs_rejected"]["value"] >= 1


def test_a_failing_proof_is_not_correct(root, monkeypatch):
    """A proof that raises in the window is counted; one that raises in
    set-up ends the run with no result."""
    prove, calls = api.prove_file, []

    def fails_third(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return prove(*a, **kw)

    monkeypatch.setattr(api, "prove_file", fails_third)
    line = _run(root)
    assert not line["correct"]
    assert line["compared"]["proofs_failed"]["value"] == 1

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(api, "prove_file", broken)
    with pytest.raises(RuntimeError):
        _run(root)


def test_a_proof_of_another_witness_is_not_correct(root, monkeypatch):
    """The window's proofs prove a satisfying witness other than the file
    they were given (the next file of the pool, which no other proof
    proves): each verifies and repeats no commitment, but its wires are not
    those of its own witness."""
    prove, calls = api.prove_file, []
    warm = json.loads((root / "prover_bench" / "traffic" / "per_phase.json")
                      .read_text())["warmup_proofs"]

    def other(bytecode, witness, out, *a, **kw):
        calls.append(1)
        if len(calls) > warm:
            head, _, tail = witness.rpartition("/w")
            witness = f"{head}/w{int(tail.split('.')[0]) + 1}.gz"
        return prove(bytecode, witness, out, *a, **kw)

    monkeypatch.setattr(api, "prove_file", other)
    line = _run(root)
    assert not line["correct"]
    c = line["compared"]
    assert c["wires_not_own"]["value"] == c["wires_not_own"]["checked"] >= 1
    assert c["proofs_rejected"]["value"] == 0
    assert c["proofs_repeated"]["value"] == 0


def test_an_altered_witness_fill_is_not_correct(root, monkeypatch):
    """A value altered where the program's witness fill produces it: the
    wires differ from the witness file's, and the proof does not verify."""
    from tpu_acir_prover_torch.circuit.compile import CompiledCircuit
    fill = CompiledCircuit.generate_witness

    def altered(self, external_values):
        vals = fill(self, external_values).copy()
        vals[-1] = (int(vals[-1]) + 1) % (2 ** 64 - 2 ** 32 + 1)
        return vals

    monkeypatch.setattr(CompiledCircuit, "generate_witness", altered)
    line = _run(root)
    assert not line["correct"]
    assert line["compared"]["wires_not_own"]["value"] >= 1
    assert line["compared"]["proofs_rejected"]["value"] >= 1


def test_a_wrong_output_in_the_inputs_ends_the_run(root, monkeypatch):
    """A witness file whose returned value is not the program's output is a
    fault of the benchmark's own inputs: set-up ends the run, no result."""
    from prover_bench.programs import square_chain
    witness = square_chain.witness

    def wrong(cfg, inputs):
        wm = witness(cfg, inputs)
        wm[cfg["steps"]] = (wm[cfg["steps"]] + 1) % (2 ** 64 - 2 ** 32 + 1)
        return wm

    monkeypatch.setattr(square_chain, "witness", wrong)
    with pytest.raises(SystemExit, match="plain reference"):
        _run(root)


def test_the_witness_pool_stays_out_of_setup_s(root, monkeypatch, capsys):
    """The witness files are the benchmark's inputs, not the program's
    set-up: with each file's generation slowed by a fixed sleep, ``setup_s``
    stays below the pool's total sleep, which the pool's seconds on
    standard error cover."""
    from prover_bench.programs import square_chain
    witness, files, nap = square_chain.witness, [], 2.5

    def slow(cfg, inputs):
        files.append(1)
        time.sleep(nap)
        return witness(cfg, inputs)

    monkeypatch.setattr(square_chain, "witness", slow)
    line = _run(root)
    assert line["correct"], line["compared"]
    slept = nap * len(files)
    said = re.search(r"witness pool: (\d+) files in ([0-9.]+) s",
                     capsys.readouterr().err)
    assert said and int(said[1]) == len(files) >= 3
    assert float(said[2]) >= slept
    assert line["metrics"]["setup_s"]["value"] < slept


def test_missed_launches_fail_the_trace():
    s = trace.Summary(1.0, 2.0, 1, {}, {"leaf_hash": 14, "ext_prod": 14},
                      [], [])
    trace.check_launches(s, {"leaf_hash": 14, "ext_prod": 14})
    with pytest.raises(trace.TraceIncomplete):
        trace.check_launches(s, {"leaf_hash": 15, "ext_prod": 14})
    with pytest.raises(trace.TraceIncomplete):
        trace.check_launches(s, {"leaf_hash": 14, "ext_prod": 14, "grind": 1})


class _Event:
    def __init__(self, kind, name, start, end):
        self.kind, self._name, self.start, self.end = kind, name, start, end

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_launches_outside_the_window_are_named():
    """A family's record that lies outside the window's proof spans is not
    seen as launched there, and the launch check names it."""
    events = [_Event("user_annotation", trace.PROOF_SPAN, 100, 1000),
              _Event("kernel", "void leaf_hash_kernel(unsigned long const*)",
                     200, 300),
              _Event("kernel", "leaf_hash_kernel", 1500, 1600),
              _Event("kernel", "leaf_hash_kernel", 0, 0),
              _Event("kernel", "other_kernel", 400, 500)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    s = trace.summarize(Prof, {"merkle": {"leaf_hash_kernel": "leaf_hash"}})
    assert s.launches == {"leaf_hash": 1}
    assert s.outside == {"leaf_hash": 2}
    assert s.busy_s == 200 / 1e9 and s.window_s == 900 / 1e9
    trace.check_launches(s, {"leaf_hash": 1})
    with pytest.raises(trace.TraceIncomplete,
                       match="outside the window: leaf_hash 2;"):
        trace.check_launches(s, {"leaf_hash": 3})


def test_run_py_fails_without_a_card(tmp_path):
    """The command exits non-zero and prints no result on a machine without
    the cell's card."""
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, str(ROOT / "prover_bench" / "run.py"), "--workload",
         "sha256_long.single", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr
