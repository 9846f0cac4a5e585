"""``prove_sharded`` over a mesh of cards, one shard a card, against the
per-phase proof on the first card: the bytes must be equal.

    python -m tpu_acir_prover_torch.parallel.cards

proves the 2^17-row ECDSA circuit and ``mul_chain_circuit(20)`` at
``STANDARD_CONFIG`` over every visible card, two warm proofs each way, and
prints one JSON line per circuit: key-build and proof times on one card
and over the mesh, each card's peak allocated memory, and the cards' names
and power limits.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _timed(fn, devices):
    _sync(devices)
    t0 = time.perf_counter()
    out = fn()
    _sync(devices)
    return out, time.perf_counter() - t0


def _peaks_gib(devices):
    return [torch.cuda.max_memory_allocated(d) / 2**30 for d in devices
            if d.type == "cuda"]


def _reset_peaks(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def compare(name, cc, ext, mesh):
    """One circuit: two warm proofs per-phase on the mesh's first device,
    then two sharded."""
    from ..prover.config import STANDARD_CONFIG
    from ..prover.prove import ProvingKey, prove
    from ..prover.serialization import serialize_proof
    from ..prover.verify import verify
    from .prove import ShardedProvingKey, prove_sharded
    devs = list(dict.fromkeys(mesh.devices))
    rec = {"circuit": name, "log_n": cc.log_n, "shards": mesh.size,
           "devices": [str(d) for d in mesh.devices]}
    for tag, make, prover in (
            ("one_device", lambda: ProvingKey(cc, STANDARD_CONFIG,
                                              device=mesh.devices[0]), prove),
            ("sharded", lambda: ShardedProvingKey(cc, STANDARD_CONFIG,
                                                  mesh=mesh), prove_sharded)):
        _reset_peaks(devs)
        key, rec[f"{tag}_key_s"] = _timed(make, devs)
        times = []
        for _ in range(2):
            _reset_peaks(devs)
            proof, dt = _timed(lambda: prover(key, ext), devs)
            times.append(dt)
        rec[f"{tag}_proof_s"] = times
        rec[f"{tag}_peak_gib"] = _peaks_gib(devs)
        verify(key.vk, proof)
        data = serialize_proof(proof)
        if tag == "one_device":
            want = data
        elif data != want:
            raise AssertionError(f"{name}: sharded bytes differ")
        del key, proof
        if mesh.devices[0].type == "cuda":
            torch.cuda.empty_cache()
    rec["bytes_equal"] = True
    return rec


def main():
    from ..acir.translator import translate_program
    from ..circuit.compile import compile_circuit
    from ..utils import circuits
    from ..utils.bench_circuits import mul_chain_circuit
    from .mesh import Mesh

    if not torch.cuda.is_available():
        raise SystemExit("cards: torch.cuda.is_available() is false")
    mesh = Mesh([f"cuda:{s}" for s in range(torch.cuda.device_count())])
    for d in mesh.devices:   # each card's allocator, before its stats
        torch.ones(1, device=d)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    prog, wm = circuits.ecdsa_secp256k1()
    tr = translate_program(prog)
    for name, cc, ext in (
            ("ecdsa_secp256k1", compile_circuit(tr.builder),
             tr.external_values(wm)),
            ("mul_chain", mul_chain_circuit(20), np.array([], np.uint64))):
        rec = compare(name, cc, ext, mesh)
        rec["cards"] = smi.splitlines()
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
