"""The port's measuring scripts rehearsed on the CPU at small sizes:
``parallel/scaling.py`` (its points and summary line in ``scaling.py``'s
form) and ``bench_torch.py`` (one JSON line per metric under
``bench.py``'s names, each naming its device, the headline last).  Times
taken here are CPU times and are checked only for their form."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_acir_prover_torch.parallel import scaling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_scaling_sweep_on_cpu_shards(monkeypatch, capsys):
    monkeypatch.setattr(scaling, "SHARD_COUNTS", (1, 2, 4))
    monkeypatch.setenv("SCALING_LOG_PER_SHARD", "4")
    monkeypatch.setenv("SCALING_REPS", "1")
    assert scaling.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    points = re.findall(r"^  sp=(\d+) n=2\^(\d+) warmup=[\d.]+s "
                        r"steady=[\d.]+s$", err, re.M)
    assert points == [("1", "4"), ("2", "5"), ("4", "6")]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"].startswith(
        "sharded_weak_scaling_efficiency_sp4 (2^4 rows/shard, shards on cpu)"
        " curve={'sp1': ")
    assert rec["unit"] == "t(sp1)/t(spN)"
    assert rec["value"] == rec["vs_baseline"] > 0


def test_scaling_sweep_hands_each_point_to_check(monkeypatch):
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.prover.serialization import serialize_proof
    from tpu_acir_prover_torch.prover.verify import verify
    monkeypatch.setattr(scaling, "SHARD_COUNTS", (1, 2))
    points = []
    scaling.sweep("cpu", 4, 1, check=lambda spk, proof: points.append(
        (len(spk.mesh.devices), spk, proof)))
    assert [(s, spk.n) for s, spk, _ in points] == [(1, 16), (2, 32)]
    for _, spk, proof in points:
        verify(spk.vk, proof)
        one = ProvingKey(spk.compiled, spk.config, device="cpu")
        assert serialize_proof(proof) == serialize_proof(
            prove(one, np.array([], dtype=np.uint64)))


def test_scaling_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        scaling.main([])


def _bench(mode, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_MODE=mode, BENCH_LOG_N="5",
               BENCH_REPS="2", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "bench_torch.py", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("mode,metric", [
    ("ntt", "goldilocks_ntt_butterflies_per_s_chip (2^5 x 6)"),
    ("prove", "prover_wall_time_2pow5_rows")])
def test_bench_lines_on_cpu(mode, metric):
    res = _bench(mode, "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert [rec["metric"] for rec in lines] == [metric]
    for rec in lines:
        assert rec["device"] == "cpu"
        assert {"value", "unit", "vs_baseline"} <= set(rec)
        assert rec["value"] > 0
    if mode == "prove":
        # the Rust yardstick is a 2^20-row proof: no ratio at 2^5
        assert lines[-1]["vs_baseline"] is None
        assert lines[-1]["prover"] == "fused"
        assert "fused_device" in res.stderr and "pk_build" in res.stderr


def test_bench_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _bench("ntt")
    assert res.returncode != 0
    assert res.stdout == ""
