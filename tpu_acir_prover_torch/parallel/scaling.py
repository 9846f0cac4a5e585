"""Weak-scaling sweep of ``prove_sharded``: fixed rows per shard, 1, 2, 4
and 8 shards.

    python -m tpu_acir_prover_torch.parallel.scaling [--device D]

Counterpart of the JAX package's ``scaling.py``.  For each shard count S
it proves ``mul_chain_circuit`` at 2^SCALING_LOG_PER_SHARD (default
``LOG_PER_SHARD``) rows a shard times S, at ``TEST_CONFIG``: a key build
and one warm-up proof, then SCALING_REPS (default ``REPS``) proofs, whose
minimum is the steady state.  The shards lie on ``--device`` (default
``cuda``), all on one device, or one a card when ``--device cuda`` sees
several cards; with more shards than cards the sweep stops there.  One
stderr line per point, then one JSON line on stdout: the parallel
efficiency t(S=1)/t(S=max), which is 1.0 for perfect weak scaling.  Shards that share one card also
share its launches, so there the curve shows what each added shard costs
(its launches and collectives), not a speed-up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# the shard counts of the sweep, its rows a shard (log 2) and its timed
# proofs a point
SHARD_COUNTS = (1, 2, 4, 8)
LOG_PER_SHARD = 10
REPS = 2


def _mesh(device: torch.device, shards: int):
    """The sweep's mesh of ``shards`` shards, or None where there are fewer
    cards than shards."""
    from .mesh import Mesh
    cards = torch.cuda.device_count() if device.type == "cuda" and \
        device.index is None else 1
    if cards == 1:
        return Mesh.on(device, shards)
    return Mesh([f"cuda:{i}" for i in range(shards)]) if shards <= cards \
        else None


def _where(mesh, device: torch.device) -> str:
    """The sweep's devices, named as its summary line names them."""
    if device.type != "cuda":
        return f"shards on {device}"
    name = torch.cuda.get_device_name(mesh.devices[0])
    cards = len(set(mesh.devices))
    return f"shards on one {name}" if cards == 1 else \
        f"one shard a card, {cards} x {name}"


def sweep(device, log_per_shard: int = LOG_PER_SHARD, reps: int = REPS,
          check=None) -> dict:
    """The sweep over SHARD_COUNTS, one stderr line a point; returns the
    summary line's JSON object.  ``check``, if given, is called with each
    point's key and last proof, after its timed proofs."""
    from ..prover.config import TEST_CONFIG
    from ..prover.prove import resolve_device
    from ..utils.bench_circuits import mul_chain_circuit
    from .cards import _sync
    from .prove import ShardedProvingKey, prove_sharded

    device = resolve_device(device)
    ext = np.array([], dtype=np.uint64)
    results, where = {}, None
    for sp in SHARD_COUNTS:
        mesh = _mesh(device, sp)
        if mesh is None:
            break
        where = _where(mesh, device)
        n_log = log_per_shard + sp.bit_length() - 1
        cc = mul_chain_circuit(n_log)
        _sync(mesh.devices)
        t0 = time.perf_counter()
        spk = ShardedProvingKey(cc, TEST_CONFIG, mesh=mesh)
        prove_sharded(spk, ext)
        _sync(mesh.devices)
        warm = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            proof = prove_sharded(spk, ext)
            _sync(mesh.devices)
            ts.append(time.perf_counter() - t0)
        results[sp] = min(ts)
        print(f"  sp={sp} n=2^{n_log} warmup={warm:.1f}s "
              f"steady={results[sp]:.3f}s", file=sys.stderr, flush=True)
        if check is not None:
            check(spk, proof)
        del spk, proof
    base = results[1]
    eff = {sp: round(base / dt, 3) for sp, dt in results.items()}
    curve = {f"sp{sp}": round(dt, 3) for sp, dt in results.items()}
    max_sp = max(results)
    return {
        "metric": f"sharded_weak_scaling_efficiency_sp{max_sp} "
                  f"(2^{log_per_shard} rows/shard, {where}) curve={curve}",
        "value": eff[max_sp],
        "unit": "t(sp1)/t(spN)",
        "vs_baseline": eff[max_sp],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_acir_prover_torch.parallel.scaling")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the shards (default: cuda)")
    args = ap.parse_args(argv)
    line = sweep(args.device,
                 int(os.environ.get("SCALING_LOG_PER_SHARD", LOG_PER_SHARD)),
                 int(os.environ.get("SCALING_REPS", REPS)))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
