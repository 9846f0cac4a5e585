"""Times the Poseidon2 kernels on the card at the main path's shapes.

    python -m tpu_acir_prover_torch.kernels.bench [--out FILE]

Each time is the mean over repeated calls, by CUDA events, after a warm-up,
on inputs made from a seed:

- ``leaf_hash`` at the ECDSA circuit's oracle widths (2^20 rows of 43, 17,
  18, 12 and 4 columns);
- ``merkle_levels`` of a 2^20-leaf tree up to its 16-digest cap (an oracle
  commit of the ECDSA proof) and of the 12 FRI-layer trees (2^19 .. 2^8
  leaves, same cap);
- ``permute`` on (2^17, 12) states, and on one state;
- ``gl_mul``: the latency of one dependent Goldilocks product, from a chain
  of products on one thread (the difference of two chain lengths over the
  difference of their counts, so the launch drops out);
- ``duplex``: the transcript's duplex, per call back to back, and per
  duplex in a CUDA graph of a chain of 223 dependent duplexes of 8 inputs
  each (the ECDSA proof's count) replayed, the chain's output held against
  the plain twin's;
- ``grind``: the mean time over 64 seeded states at 16 PoW bits, the
  nonce lane and the pending inputs varying with the seed.

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
from tpu_acir_prover_torch.field import poseidon as plain
from tpu_acir_prover_torch.kernels import poseidon as kp
from tpu_acir_prover_torch.prover.merkle import merkle_levels

LEAF_WIDTHS = (43, 17, 18, 12, 4)
LEAF_ROWS = 1 << 20
CAP = 16
FRI_LEAVES = tuple(1 << k for k in range(19, 7, -1))
EDGES = (0, gl.P - 1, 1 << 32, (1 << 32) - 1)
DUPLEXES = 223          # duplexes in a fused ECDSA proof's transcript
MUL_CHAIN = 1 << 16     # products in the longer latency chain
GRIND_STATES = 64
GRIND_BITS = 16


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


def gl_mul_latency_ms(device) -> float:
    """Latency of one dependent gl_mul on the card, in ms."""
    lib = kp._lib_for(torch.empty(1, device=device))
    out = torch.empty(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def chain(n):
        kp._check(lib, lib.p2_mul_chain(0x123456789ABCDEF, n, out.data_ptr(),
                                        stream), "mul_chain")

    t0 = cuda_ms(lambda: chain(0), 20)
    t1 = cuda_ms(lambda: chain(MUL_CHAIN), 20)
    return (t1 - t0) / MUL_CHAIN


def duplex_replay(state, pool):
    """A CUDA graph of len(pool) dependent duplexes, each absorbing the 8
    values of its row of pool, replayed: (ms per duplex, the chain's output
    after the last replay, the same chain by the plain twin)."""
    rows = [list(r.unbind()) for r in pool]

    def chain(duplex):
        st = state
        for r in rows:
            st = duplex(st, r)
        return st

    chain(kp.duplex)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain(kp.duplex)
    ms = cuda_ms(graph.replay, 20) / len(rows)
    return ms, out.clone(), chain(plain.duplex)


def grind_ms(states):
    """Per (state, lane, inputs), the grind's time and its nonce."""
    ms, nonces = [], []
    for st, lane, inputs in states:
        nonces.append(int(kp.grind(st, lane, GRIND_BITS, inputs)))
        ms.append(cuda_ms(lambda: kp.grind(st, lane, GRIND_BITS, inputs), 5))
    return ms, nonces


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
    emit({"kernel": "gl_mul", "chain": MUL_CHAIN,
          "latency_ms": gl_mul_latency_ms(dev)})
    state = field_input(rng, (12,), dev)
    pool = field_input(rng, (DUPLEXES, 8), dev)
    inputs = list(pool[0].unbind())
    replay_ms, got, want = duplex_replay(state, pool)
    if not torch.equal(kp.duplex(state, inputs), plain.duplex(state, inputs)) \
            or not torch.equal(got, want):
        raise AssertionError("duplex differs from the plain twin")
    emit({"kernel": "duplex",
          "eager_ms": cuda_ms(lambda: kp.duplex(state, inputs), 50),
          "replay_ms": replay_ms})
    states = []
    for s in range(GRIND_STATES):
        lane = s % 8
        states.append((field_input(np.random.default_rng(s), (12,), dev),
                       lane, list(field_input(np.random.default_rng(s + 1000),
                                              (8,), dev)[:lane].unbind())))
    ms, nonces = grind_ms(states)
    for (st, lane, inputs), n in zip(states, nonces):
        if n != int(plain.grind(st, lane, GRIND_BITS, inputs)):
            raise AssertionError("grind differs from the plain twin")
    emit({"kernel": "grind", "bits": GRIND_BITS, "states": len(states),
          "mean_ms": float(np.mean(ms)), "mean_nonce": float(np.mean(nonces)),
          "ms": ms, "nonces": nonces})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
