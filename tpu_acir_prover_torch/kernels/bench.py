"""Times the Poseidon2 kernels on the card at the main path's shapes.

    python -m tpu_acir_prover_torch.kernels.bench [--out FILE]

Each time is the mean over repeated calls, by CUDA events, after a warm-up,
on inputs made from a seed:

- ``leaf_hash`` at the ECDSA circuit's oracle widths (2^20 rows of 43, 17,
  18, 12 and 4 columns);
- ``merkle_levels`` of a 2^20-leaf tree up to its 16-digest cap (an oracle
  commit of the ECDSA proof) and of the 12 FRI-layer trees (2^19 .. 2^8
  leaves, same cap);
- ``permute`` on (2^17, 12) states, and on one state: the latency of a
  permutation, the floor of a Merkle level and the transcript's duplex.

These go through ``leaf_hash``, ``merkle_levels`` and ``permute`` alone, so
the script also times an earlier checkout of the port: run it by path with
that checkout first on ``PYTHONPATH``.

Prints one JSON object per line and writes them all to ``--out`` (default
``chiprun_out/bench_kernels.json``), each with the card's name and power
limit.  Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from tpu_acir_prover_torch.field import gl
from tpu_acir_prover_torch.kernels import poseidon as kp
from tpu_acir_prover_torch.prover.merkle import merkle_levels

LEAF_WIDTHS = (43, 17, 18, 12, 4)
LEAF_ROWS = 1 << 20
CAP = 16
FRI_LEAVES = tuple(1 << k for k in range(19, 7, -1))
EDGES = (0, gl.P - 1, 1 << 32, (1 << 32) - 1)


def cuda_ms(fn, reps):
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def field_input(rng, shape, device):
    """Canonical values < p from ``rng``, with the edge values 0, p - 1,
    2^32 and 2^32 - 1 at up to 4096 random places."""
    v = rng.integers(0, gl.P, size=shape, dtype=np.uint64).reshape(-1)
    pos = rng.choice(v.size, size=min(v.size, 4096), replace=False)
    v[pos] = np.array(EDGES, dtype=np.uint64)[np.arange(pos.size) % 4]
    return gl.from_u64(v.reshape(shape), device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/bench_kernels.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    rows = []

    def emit(rec):
        rec["card"] = card
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    for c in LEAF_WIDTHS:
        x = field_input(rng, (LEAF_ROWS, c), dev)
        emit({"kernel": "leaf_hash", "shape": [LEAF_ROWS, c],
              "ms": cuda_ms(lambda: kp.leaf_hash(x), 10)})
    leaves = {m: field_input(rng, (m, 4), dev)
              for m in (LEAF_ROWS,) + FRI_LEAVES}
    emit({"kernel": "merkle_levels",
          "oracle_tree_ms": cuda_ms(
              lambda: merkle_levels(leaves[LEAF_ROWS], CAP), 10),
          "fri_trees_ms": cuda_ms(
              lambda: [merkle_levels(leaves[m], CAP) for m in FRI_LEAVES],
              10)})
    for b in (1 << 17, 1):
        st = field_input(rng, (b, 12), dev)
        emit({"kernel": "permute", "shape": [b, 12],
              "ms": cuda_ms(lambda: kp.permute(st), 20)})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
