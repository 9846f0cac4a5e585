"""``prove_sharded`` on the lookup circuit over 1, 2, 4 and 8 CPU shards
(bytes equal to the JAX numpy oracle's and to the single-device port's,
verified), and ``parallel/cards.py``'s comparison rehearsed on CPU shards.
Apart from ``test_torch_sharded.py`` so that the two run on separate
workers."""

import numpy as np
import pytest
import torch

from tpu_acir_prover_torch.parallel import cards
from tpu_acir_prover_torch.parallel.mesh import Mesh
from tpu_acir_prover_torch.prover import config
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.utils.bench_circuits import mul_chain_circuit

from sharded_cases import SHARDS, check_sharded_proof

torch.set_num_threads(1)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", ["lookup_bits=8"])
def test_sharded_proof_bytes_match(name, shards):
    check_sharded_proof(name, shards)


def test_cards_script_rehearses_on_cpu_shards(monkeypatch):
    """``parallel/cards.py``'s comparison on 4 CPU shards (at the test
    config, for time): the benchmark circuit, bytes equal."""
    monkeypatch.setattr(config, "STANDARD_CONFIG", TEST_CONFIG)
    rec = cards.compare("mul_chain", mul_chain_circuit(5),
                        np.array([], dtype=np.uint64), Mesh.on("cpu", 4))
    assert (rec["circuit"], rec["shards"], rec["bytes_equal"]) == \
        ("mul_chain", 4, True)
    assert len(rec["sharded_proof_s"]) == 2
    assert rec["sharded_peak_gib"] == []
