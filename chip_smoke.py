#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``tpu_acir_prover_torch``) on one
NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each printed as it ends; any failure raises and exits non-zero:

1. device: the card's name and power limit;
2. build: the Poseidon2 and field kernels from
   ``tpu_acir_prover_torch/csrc``, one nvcc a library, started together,
   with ptxas's registers and spills per kernel;
3. parity: proof bytes of the port on the card equal those of the port on
   the CPU (plain twins), on a plain and a lookup circuit (test config),
   from the per-phase prover and from the fused prover's CUDA graph; the
   CPU tests hold the CPU bytes to the JAX package's numpy prover;
4. main path: the port's CLI proves the 2^17-row ECDSA secp256k1 circuit
   (standard config, LDE 2^20 rows) on the fused path, which captures the
   proof as one CUDA graph and replays it; it writes the vk and verifies;
   the port's verifier accepts the proof and rejects it with a byte
   flipped;
5. fused: the graph's capture and instantiate times, its pool and its
   kernel launches; warm fused and per-phase proofs of the ECDSA circuit in
   turns, two each, with their upper medians, bytes and peak memory; the
   synchronising calls of each; one replay under ``torch.profiler``: its
   device operations, device time, the device's idle share and each
   Poseidon2 and field kernel's count and device time (the field kernels'
   also by path); the replay's ext_mul + ext_prod launches, fewer than the
   528 ext_mul launches of a replay before ext_prod;
6. profile: one warm per-phase proof under ``torch.profiler``, the device
   time of all kernels, of the Poseidon2 kernels and of the field kernels;
7. sharded: ``prove_sharded`` with every shard on cuda:0.  Parity: over 2
   and 4 shards on the two small circuits, bytes equal to the port's on
   the CPU.  The ECDSA circuit over 4 shards: key build, a warm proof
   with its phases, peak memory and kernel launches (counted from 0),
   bytes equal to the CLI's, verified, beside the per-phase proof of
   [fused].  The 2^20-row ``mul_chain`` circuit (standard config, LDE 2^23
   rows): one per-phase proof on a plain key, then ``prove_fused`` on the
   same key (its eager run, the graph's capture and instantiation, then a
   warm proof: times, pool, peak memory and the graph's kernel launches,
   and one replay under ``torch.profiler`` as in [fused]),
   then over 4 shards (2 if 4 run out of memory, with the error printed),
   bytes equal, all verified; the key build's and the per-phase proof's
   peaks beside those before the commit ran its NTTs in column blocks.
   Each of these four paths records the shapes it gives ``leaf_hash`` and
   ``two_to_one_levels``.  Then the memory still allocated on the card,
   with no garbage collected: a dropped sharded key frees its tensors at
   once;
8. sha256: the SHA-256 circuits of ``utils/circuits.py``.  Parity: the
   2^16-row one-compression circuit (test config) proven per-phase and
   fused, bytes equal, both verified.  The port's CLI proves, writes the
   vk of and verifies a saved ``sha256_multiblock(2)`` (2^17 rows,
   standard config) on the fused path: the key build, the first proof
   (eager run, capture, instantiate) with its peak, then warm fused and
   per-phase proofs in turns, two each, with their phases, upper medians,
   peaks and launches, and the graph's pool; the port's verifier accepts
   the proof and rejects it with a byte flipped.  The longest chained
   message that compiles to 2^20 rows (``SHA_LONG_BLOCKS`` blocks):
   ``api.prove_file`` translates, compiles, builds the key and proves it
   per-phase, then ``prove_fused`` proves it on the same key (first proof,
   capture, instantiate, a warm proof, pool, peak); bytes equal, both
   verified.  Each path records its shapes as the paths of [sharded] do;
9. scaling: the weak-scaling sweep of ``parallel/scaling.py`` at its
   default size (2^10 rows a shard, 1 to 8 shards) with one timed proof
   a point, on cuda:0, and its line;
   each point's last proof verified, the one over 8 shards equal to the
   port's on the CPU; the sweep records its shapes as the paths of
   [sharded] do;
10. field: each field kernel (``csrc/field.cu``: ``gl_binary_kernel`` for
    add, sub and mul, ``gl_pow_kernel``, ``ext_mul_kernel``,
    ``ext_prod_kernel``, ``ext_inv_kernel``) against its plain torch twin on
    the card, bit for bit, at the main path's shapes: a (2^20, 43) matrix
    times a (2^20, 1) column, the NTT's strided radix-4 views at 2^23 rows
    against (1, h, 1) twiddles, a quotient chunk's (2^18,) inverses, round
    2's (2^17,) ext columns, its group products over (2^17, 16) ext pairs
    and (2^17, 16) ext inverses; then at every layout (sizes and strides
    after the wrapper's merging; ext_prod's columns) that the paths above
    gave a field kernel, recorded as they ran: each held bit for bit, the
    largest of each class (kernel, op, path in the kernel, rank, broadcast
    dimensions) also timed; with the kernel's device time (a CUDA graph of
    launches, each after a read of 256 MiB that evicts the L2 cache,
    replayed under ``torch.profiler``), the twin's, the card's bound
    (bytes, or the products times the SASS instructions of one product)
    and the kernel's launches in the main path's run.  Also: the path each class takes and
    the launches of each path of the kernels per prover path, the general
    path's among them; the wrappers' host time per call; and, for the fused
    ECDSA and 2^20 ``mul_chain`` replays, each field kernel's launches,
    device time, the sum of its launches' bounds from the layouts the
    capture recorded, and the share of that bound;
11. kernels: each kernel against its plain torch twin on the card, bit
    for bit, with both times and the card's bound for the same work: at
    the main path's shapes (the grind from the ECDSA proof's own state;
    the duplex on k = 8 inputs that are views into two tensors, and a
    replayed CUDA graph of a chain of 223 duplexes, timed and held against
    the twin's chain, with a latency bound from the measured latency of
    one dependent Goldilocks product), then at every Merkle-commit shape
    the paths of [sharded], [sha256] and [scaling] recorded: each oracle's
    LDE block and its subtree (the kernel hashes a 2^23-row block whole;
    its twin, row-local like it, the first and last 2^18 rows, which it is
    held to).  One record per kernel and shape, with the first path that
    gives it that shape and the kernel's launches in that path's run (the
    main path's: the CLI's eager proof and the graph's capture; the fused
    2^20 proofs': one replay, as the capture counted them; the sweep's:
    all of it; the others': as each record's ``launches_in`` says), and in
    ``also_in`` each later path that gives it the same shape, with that
    path's launches.

The last three lines are a JSON object with a record per kernel and
shape, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  The port needs neither JAX nor the JAX package, and this script
makes sure of it by blocking both imports.
"""

import sys

# the port and this script must run without JAX and without the JAX package
sys.modules["jax"] = None
sys.modules["tpu_acir_prover"] = None

import collections  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

PALLAS = "tpu_acir_prover/kernels/poseidon_pallas.py"
SOURCE = "tpu_acir_prover_torch/csrc/poseidon2.cu"
REPLACES = {"leaf_hash": f"{PALLAS}:233", "two_to_one_level": f"{PALLAS}:283",
            "permute": f"{PALLAS}:155",
            "duplex": "tpu_acir_prover/prover/fused.py:81",
            "grind": "tpu_acir_prover/prover/fused.py:195"}
# kernels with no caller on the main path: the batched permutation (the
# transcript duplexes with its own kernel)
OFF_PATH = ("permute",)
LEAF_WIDTHS = (43, 17, 18, 12, 4)   # the ECDSA circuit's oracle widths
LEAF_ROWS = 1 << 20                 # its LDE rows at rate 8
TREE_CAP = 16                       # its Merkle cap (cap height 4)
PERMUTE_STATES = 1 << 17            # a batch as large as the plain grind's
POW_BITS = 16                       # STANDARD_CONFIG's
ALTERNATIONS = 2                    # warm fused / per-phase proofs, in turns
POSEIDON_KERNELS = ("leaf_hash_kernel", "merkle_levels_kernel",
                    "permute_kernel", "duplex_kernel",
                    "grind_kernel")  # csrc/poseidon2.cu
# the sharded and per-phase provers' kernels: their transcript is the host's
SHARDED_PATH = ("leaf_hash", "two_to_one_level", "grind")
SHARDS = 4                          # shards of the full-width proofs
SHARDS_SMALL = (2, 4)               # shards of the parity proofs
SCALING_REPS = 1                    # timed proofs a point of the sweep
MUL_CHAIN_LOG_N = 20                # bench.py's headline circuit
# leaf_hash's twin hashes blocks of up to TWIN_WHOLE_ROWS rows whole; of a
# larger block (2^23 rows at 2^20) only the first and last TWIN_END_ROWS,
# which still reach past the block's first 2^31 bytes
TWIN_WHOLE_ROWS = 1 << 21
TWIN_END_ROWS = 1 << 18
# the fused prover's kernels: the transcript runs on the card
FUSED_PATH = ("leaf_hash", "two_to_one_level", "duplex", "grind")
# the 2^20 mul_chain key build's and per-phase proof's peaks (GiB) before
# the commit ran its NTTs in column blocks (NVIDIA H100 80GB HBM3, 700 W)
UNBLOCKED_PEAKS_GIB = {"key": 31.462, "proof": 37.408}
SHA_CLI_BLOCKS = 2                  # the JAX package's slow test: 2^17 rows
# api's steps that the [sha256] phase times, each with its peak
API_CALLS = ("translate_program", "compile_circuit", "ProvingKey", "prove",
             "prove_fused")

# The card's bound for a batch of Poseidon2 permutations: the larger of its
# bytes over the memory rate and its 32-bit multiply-adds over their peak
# rate.  A permutation is 736 Goldilocks products of 8 multiply-adds each;
# an H100 SXM does 132 SMs x 64 multiply-adds per clock at 1.98 GHz (the
# published 67 TFLOP/s fp32 over 4) and moves 3.35 TB/s.
MADDS_PER_PERMUTATION = 736 * 8
MADDS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
# The field kernels (csrc/field.cu) and the JAX package's field ops that XLA
# fuses into its jitted phases (no pallas_call): the kernel's launch counter
# and its profiler name, and the reference op of each case
FIELD_SOURCE = "tpu_acir_prover_torch/csrc/field.cu"
FIELD_KERNELS = ("gl_binary_kernel", "gl_pow_kernel", "ext_mul_kernel",
                 "ext_prod_kernel", "ext_inv_kernel")
JGL = "tpu_acir_prover/field/gl.py"
JEXT = "tpu_acir_prover/field/ext.py"
FIELD_REPLACES = {"add": f"{JGL}:98", "sub": f"{JGL}:125",
                  "mul": f"{JGL}:211", "pow": f"{JGL}:221",
                  "inv": f"{JGL}:239",
                  "ext_mul": f"{JEXT}:37", "ext_inv": f"{JEXT}:53",
                  "ext_prod": f"{JEXT}:37"}
FIELD_ROWS = 1 << 20                # the ECDSA circuit's LDE rows
FIELD_NTT_ROWS = 1 << 23            # mul_chain 2^20's LDE rows
FIELD_NTT_COLS = 8                  # a column block of 2^26 LDE elements
FIELD_NTT_HALF = 1 << 10            # h of a radix-4 pass, (-1, 2, 2, h, c)
FIELD_TRACE_ROWS = 1 << 17          # the ECDSA trace: round 2's rows
FIELD_CHUNK = 1 << 18               # a quotient chunk (QUOTIENT_CHUNK)
FIELD_WIRES = 16                    # the ECDSA circuit's wire columns
FIELD_OPS = ("add", "sub", "mul")   # gl_binary_kernel's op codes
FIELD_PATHS = ("flat", "rows", "tiled", "general")   # csrc/field.cu's Path
# a fused ECDSA replay's ext_mul launches before ext_prod took the column
# folds (NVIDIA H100 80GB HBM3, 700 W)
EXT_MUL_REPLAY_BEFORE = 528
GENERAL_LARGE = 1 << 16             # elements: general unexpected above rank 1
# The Goldilocks products of one inverse: gl_inv's addition chain for
# p - 2 in csrc/field.cu, 64 squarings and 9 multiplies
INV_PRODUCTS = 64 + 9
# The duplex's bound is one of latency: the dependent Goldilocks products
# on its critical path (8 external rounds x a three-deep S-box, 22 internal
# rounds x (S-box + the diagonal product)) times the measured latency of
# one.  It is bound by operations, their chain rather than their rate, and
# its record says so in bound_kind.
DUPLEX_CHAIN_PRODUCTS = 8 * 3 + 22 * (3 + 1)


def say(msg):
    print(msg, flush=True)


def reset_launches():
    """Sets every kernel wrapper's launch count to 0."""
    from tpu_acir_prover_torch.kernels import field as kf
    from tpu_acir_prover_torch.kernels import poseidon as kp
    kp.reset_launches()
    kf.reset_launches()


def all_launches():
    """Every kernel wrapper's launch count, Poseidon2's and the field's."""
    from tpu_acir_prover_torch.prover.fused import all_launches
    return all_launches()


def bound(permutations, nbytes):
    """(bound_ms, bound_by) for a batch of permutations moving nbytes."""
    ops_ms = permutations * MADDS_PER_PERMUTATION / MADDS_PER_S * 1e3
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def max_abs_err(got, want):
    """The largest |kernel - twin| over the outputs' field elements, as
    integers; only the elements that differ are read back."""
    from tpu_acir_prover_torch.field import gl
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        bad = a != b
        if bool(bad.any()):
            x = gl.to_u64(a[bad]).astype(object)
            y = gl.to_u64(b[bad]).astype(object)
            err = max(err, int(abs(x - y).max()))
    return err


def _once_ms(fn):
    """fn's output and the device time of that one call, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def shapes_seen(log):
    """While open, counts in ``log`` the calls of ``leaf_hash`` per input
    shape and of ``two_to_one_levels`` per (children, levels).  The
    wrappers run unchanged and count their own launches."""
    from tpu_acir_prover_torch.kernels import poseidon as kp
    leaf, levels = kp.leaf_hash, kp.two_to_one_levels

    def leaf_spy(matrix):
        log[("leaf_hash", tuple(matrix.shape))] += 1
        return leaf(matrix)

    def levels_spy(child, n_levels):
        log[("two_to_one_level", (child.shape[0], n_levels))] += 1
        return levels(child, n_levels)

    kp.leaf_hash, kp.two_to_one_levels = leaf_spy, levels_spy
    try:
        yield log
    finally:
        kp.leaf_hash, kp.two_to_one_levels = leaf, levels


@contextlib.contextmanager
def timed_calls(module, names, out):
    """While open, each call of ``module``'s functions ``names`` is timed
    (the card synchronised before and after) and its peak allocated memory
    taken from a reset: ``out[name]`` = (seconds, peak GiB)."""
    real = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def spy(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() / 2**30)
            return result
        return spy

    for name, fn in real.items():
        setattr(module, name, timed(name, fn))
    try:
        yield out
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}")
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    """Both CUDA libraries, each by its own nvcc, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_acir_prover_torch.kernels import field as kf
    from tpu_acir_prover_torch.kernels import poseidon as kp
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build(), (kp, kf)))
    kp.permute(torch.zeros((1, 12), dtype=torch.int64, device="cuda"))
    one = torch.ones((1,), dtype=torch.int64, device="cuda")
    kf.mul(one, one)
    torch.cuda.synchronize()
    reset_launches()
    say(f"[build] {', '.join(lib.name for lib in libs)} built and loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    for m in (kp, kf):
        for line in m.ptxas_report():
            say(f"[build] ptxas: {line}")


def _twin_rows(t):
    """The row blocks of a leaf_hash input or output that its twin is held
    to: all of it, or past TWIN_WHOLE_ROWS rows its two ends (the hash is
    row-local, so the kernel's output rows there are the twin's)."""
    if t.shape[0] <= TWIN_WHOLE_ROWS:
        return [t]
    return [t[:TWIN_END_ROWS], t[-TWIN_END_ROWS:]]


def _path_cases(rng, dev, paths, done):
    """Kernel-vs-twin cases at the Merkle-commit shapes each path recorded:
    leaf_hash on every oracle's (rows, C) LDE block and two_to_one_levels
    on its digests, rows being the path's LDE rows per shard.  A shape
    that the main path or an earlier path gave already (a key of ``done``)
    is one case; the later paths, their launches and calls go to its list
    ``also``."""
    from tpu_acir_prover_torch.field import poseidon as plain
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.kernels.bench import field_input
    cases = []
    for path in paths:
        rows = path["rows"]
        log2 = f"2^{rows.bit_length() - 1}"
        mine = sorted(k for k in path["shapes"] if k[1][0] == rows)
        if {name for name, _ in mine} != {"leaf_hash", "two_to_one_level"}:
            raise AssertionError(f"{path['path']}: no leaf_hash or no "
                                 f"two_to_one_levels on {rows} rows")
        for key in mine:
            if key in done:
                done[key].append({
                    "path": path["path"],
                    "launches": path["launches"][key[0]],
                    "launches_in": path["launches_in"],
                    "calls_at_shape": path["shapes"][key]})
                continue
            also = done[key] = []
            name, shape = key
            if name == "leaf_hash":
                c = shape[1]
                ends = "" if rows <= TWIN_WHOLE_ROWS else \
                    f"; the twin on the first and last 2^" \
                    f"{TWIN_END_ROWS.bit_length() - 1} rows"
                cases.append((
                    name, f"({log2}, {c}){ends}", path, path["shapes"][key],
                    lambda c=c, rows=rows: field_input(rng, (rows, c), dev),
                    lambda x: _twin_rows(kp.leaf_hash(x)),
                    lambda x: [plain.hash_no_pad(b) for b in _twin_rows(x)],
                    bound(rows * -(-c // 8), rows * (c + 4) * 8), also))
            else:
                lv = shape[1]
                cap = rows >> lv
                cases.append((
                    name, f"({log2}, 4) leaves -> {lv} levels to {cap} "
                    "digests", path, path["shapes"][key],
                    lambda rows=rows: field_input(rng, (rows, 4), dev),
                    lambda x, lv=lv: kp.two_to_one_levels(x, lv),
                    lambda x, lv=lv: plain.two_to_one_levels(x, lv),
                    bound(rows - cap, (2 * rows - cap) * 32), also))
    return cases


def phase_kernels(grind_state, grind_lane, main_launches, paths):
    """Kernel vs plain twin on the card; returns one record per kernel and
    shape.  The main path's shapes first (the grind searches from the ECDSA
    proof's own state and nonce lane), then the Merkle-commit shapes the
    other paths gave the kernels."""
    from tpu_acir_prover_torch.field import poseidon as plain
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.kernels.bench import (DUPLEXES, cuda_ms,
                                                     duplex_replay,
                                                     field_input,
                                                     gl_mul_latency_ms)
    rng = np.random.default_rng(2024)
    dev = torch.device("cuda")
    main = {"path": "main: the CLI's ECDSA prove", "launches": main_launches,
            "launches_in": "the CLI's run (one eager proof, then the "
            "graph's capture)", "shapes": None}
    n_levels = (LEAF_ROWS // TREE_CAP).bit_length() - 1
    # the later paths that give the main path's Merkle shapes
    done = {("leaf_hash", (LEAF_ROWS, c)): [] for c in LEAF_WIDTHS}
    done[("two_to_one_level", (LEAF_ROWS, n_levels))] = []
    cases = []
    for c in LEAF_WIDTHS:
        cases.append(("leaf_hash", f"(2^20, {c})", main, None,
                      lambda c=c: field_input(rng, (LEAF_ROWS, c), dev),
                      lambda x: [kp.leaf_hash(x)],
                      lambda x: [plain.hash_no_pad(x)],
                      bound(LEAF_ROWS * -(-c // 8), LEAF_ROWS * (c + 4) * 8),
                      done[("leaf_hash", (LEAF_ROWS, c))]))
    cases.append(("two_to_one_level",
                  f"(2^20, 4) leaves -> {n_levels} levels to a {TREE_CAP}-"
                  f"digest cap ({kp.LEVELS_PER_LAUNCH} levels per launch; "
                  f"from {kp.NARROW_CHILDREN} children up "
                  f"{kp.NARROW_LEVELS} per launch, four threads a parent)",
                  main, None, lambda: field_input(rng, (LEAF_ROWS, 4), dev),
                  lambda x: kp.two_to_one_levels(x, n_levels),
                  lambda x: plain.two_to_one_levels(x, n_levels),
                  bound(LEAF_ROWS - TREE_CAP,
                        (2 * LEAF_ROWS - TREE_CAP) * 32),
                  done[("two_to_one_level", (LEAF_ROWS, n_levels))]))
    cases.append(("permute", "(2^17, 12)", main, None,
                  lambda: field_input(rng, (PERMUTE_STATES, 12), dev),
                  lambda x: [kp.permute(x)], lambda x: [plain.permute(x)],
                  bound(PERMUTE_STATES, PERMUTE_STATES * 12 * 8 * 2), []))
    cases.append(("permute", "(1, 12): one state, beside the duplex (the "
                  "main path no longer launches permute)", main, None,
                  lambda: field_input(rng, (1, 12), dev),
                  lambda x: [kp.permute(x)], lambda x: [plain.permute(x)],
                  bound(1, 12 * 8 * 2), []))
    # k = 8 inputs: views at nonzero offsets into two tensors
    a, b = field_input(rng, (9,), dev), field_input(rng, (6,), dev)
    inputs = [a[1 + i // 2] if i % 2 == 0 else b[5 - i // 2]
              for i in range(8)]
    mul_ms = gl_mul_latency_ms(dev)
    cases.append(("duplex", "(12,) state, 8 inputs by address; ms per "
                  f"duplex in a replayed graph of {DUPLEXES}", main, None,
                  lambda: field_input(rng, (12,), dev),
                  lambda x: [kp.duplex(x, inputs)],
                  lambda x: [plain.duplex(x, inputs)],
                  (DUPLEX_CHAIN_PRODUCTS * mul_ms, "operations"), []))
    nonce = int(kp.grind(grind_state, grind_lane, POW_BITS))
    # the least work: every nonce up to the smallest hit is tried
    cases.append(("grind", f"ECDSA proof's state, nonce lane {grind_lane}, "
                  f"{POW_BITS} bits: nonce {nonce}", main, None,
                  lambda: grind_state,
                  lambda x: [kp.grind(x, grind_lane, POW_BITS)],
                  lambda x: [plain.grind(x, grind_lane, POW_BITS)],
                  bound(nonce + 1, 12 * 8 + 8), []))
    cases += _path_cases(rng, dev, paths, done)
    records = []
    for name, shape, path, calls, make, kern, twin, (bound_ms, bound_by), \
            also in cases:
        x = make()
        got = kern(x)
        want, plain_ms = _once_ms(lambda: twin(x))
        ms = cuda_ms(lambda: kern(x), 10)
        extra = {}
        if name == "duplex":
            # the timed graph is also the one held against the twin
            extra = {"eager_ms": ms, "gl_mul_latency_ms": mul_ms,
                     "throughput_bound_ms": bound(1, (12 + 8 + 12) * 8)[0]}
            ms, chain, chain_twin = duplex_replay(
                x, field_input(rng, (DUPLEXES, 8), dev))
            got, want = got + [chain], want + [chain_twin]
        torch.cuda.synchronize()
        err = max_abs_err(got, want) if len(got) == len(want) else None
        if err != 0 or \
                not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} {shape}: kernel differs from the "
                                 f"plain twin (max abs err {err})")
        del x, got, want
        kind = "latency" if name == "duplex" else "throughput"
        say(f"[kernels] {name} {shape}: bit-identical to the plain twin; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, {kind} bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound; "
            f"{path['path']}: {path['launches'][name]} launches in "
            f"{path['launches_in']}"
            + (f", calls at this shape: {calls}" if calls else "")
            + "".join(f"; also {a['path']}: {a['launches']} launches in "
                      f"{a['launches_in']}, calls at this shape: "
                      f"{a['calls_at_shape']}" for a in also)
            + "".join(f"; {k} {v:.6f}" for k, v in extra.items()))
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": path["launches"][name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape, "path": path["path"],
            "launches_in": path["launches_in"], "calls_at_shape": calls,
            "also_in": also, "bound_kind": kind, **extra})
    return records


def _read_bytes(t):
    """Bytes of ``t``'s distinct elements: a broadcast (stride 0) dimension
    is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return 8 * n


def _sass_per_product():
    """(IMAD-class, all) SASS instructions of one Goldilocks product in the
    field library: gl_binary_kernel<MUL, GENERAL> less gl_binary_kernel<ADD,
    GENERAL> (the same kernel, one element a thread, but for the op), by
    the toolkit's ``cuobjdump -sass``."""
    import re
    from pathlib import Path

    from tpu_acir_prover_torch.kernels import field as kf
    from tpu_acir_prover_torch.kernels import nvcc
    tool = Path(nvcc.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(kf.build())],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            counts[cur] = [0, 0]
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[cur][1] += 1
            counts[cur][0] += "IMAD" in line

    def of(op):
        general = FIELD_PATHS.index("general")
        names = [k for k in counts
                 if f"gl_binary_kernelILi{op}ELi{general}EE" in k]
        if len(names) != 1:
            raise AssertionError(f"gl_binary_kernel<{op}> in the SASS: "
                                 f"{names}")
        return counts[names[0]]

    (mi, ma), (ai, aa) = of(2), of(0)
    return mi - ai, ma - aa


@contextlib.contextmanager
def field_layouts(seen, captured, kernel_path):
    """While open, counts in ``seen[layout][path]`` the field kernels'
    launches by the layout the wrapper gave the kernel: (kernel, op,
    exponent or ext_prod's columns, sizes, strides per operand), after its
    merging of dimensions; ``path`` is the name last given to the function
    this yields.  Launches while a CUDA graph is being captured also count
    in ``captured[path][layout]``; ``kernel_path[layout]`` is the path the
    kernel takes.  The wrappers run unchanged and count their own
    launches."""
    from tpu_acir_prover_torch.kernels import field as kf
    launch, path = kf._launch, ["-"]

    def spy(what, fn, dev, plan, *args):
        arg = FIELD_OPS[args[0]] if what == "gl_binary" else \
            args[1] if what == "gl_pow" else plan.cols or None
        key = (what, arg, tuple(plan.sizes), tuple(map(tuple, plan.strides)))
        seen[key][path[0]] += 1
        kernel_path[key] = plan.path
        if torch.cuda.is_current_stream_capturing():
            captured[path[0]][key] += 1
        return launch(what, fn, dev, plan, *args)

    def on(name):
        path[0] = name

    kf._launch = spy
    try:
        yield on
    finally:
        kf._launch = launch


def _field_calls(what, arg):
    """(op, kernel, twin, products an element) of a field kernel and its
    op or exponent; kernel and twin take the operands in the order of the
    kernel's strides and return a list of outputs."""
    from tpu_acir_prover_torch.field import ext_plain, gl_plain
    from tpu_acir_prover_torch.kernels import field as kf
    if what == "gl_binary":
        return (arg, lambda x: [getattr(kf, arg)(*x)],
                lambda x: [getattr(gl_plain, arg)(*x)], int(arg == "mul"))
    if what == "gl_pow":
        inv = arg == gl_plain.P - 2
        return ("inv" if inv else "pow",
                lambda x: [kf.pow_const(x[0], arg)],
                lambda x: [gl_plain.pow_const(x[0], arg)],
                INV_PRODUCTS if inv else
                arg.bit_length() - 1 + bin(arg).count("1"))
    if what == "ext_mul":
        return ("ext_mul", lambda x: list(kf.ext_mul(x[:2], x[2:])),
                lambda x: list(ext_plain.mul(x[:2], x[2:])), 4)
    if what == "ext_prod":
        return ("ext_prod", lambda x: list(kf.ext_prod(x, arg)),
                lambda x: list(ext_plain.prod(x, arg)), 4 * (len(arg) - 1))
    return ("ext_inv", lambda x: list(kf.ext_inv(x)),
            lambda x: list(ext_plain.inv(x)), INV_PRODUCTS + 4)


def _hold_field(x, kern, twin, what, kernel=None):
    """The kernel's outputs on operands ``x`` against the twin's, bit for
    bit; (max_abs_err, n, outputs, kernel ms, twin ms, method): with
    ``kernel`` (its profiler name) the kernel's device time by
    ``kernels/field_bench``'s ``device_ms``, the method that measured it,
    and the twin's time by CUDA events around one call, else None for the
    three."""
    from tpu_acir_prover_torch.kernels.field_bench import device_ms
    got = kern(x)
    if kernel:
        want, plain_ms = _once_ms(lambda: twin(x))
        ms, method = device_ms(lambda: kern(x), (kernel,))
    else:
        want, plain_ms, ms, method = twin(x), None, None, None
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: kernel differs from the plain twin "
                             f"(max abs err {err})")
    return err, got[0].numel(), len(got), ms, plain_ms, method


def _field_bound(x, n, outputs, products, per_product):
    """(bound_ms, bound_by, bytes) of a field kernel's work: its distinct
    operand elements read once and its outputs written once over the
    memory rate, or its products times the SASS instructions of one over
    the multiply-add rate, whichever is longer."""
    nbytes = sum(_read_bytes(t) for t in x) + 8 * n * outputs
    ops_ms = n * products * per_product / MADDS_PER_S * 1e3
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", nbytes
    return bytes_ms, "bytes", nbytes


def _layout_bound(key, per_product):
    """(bound_ms, bound_by, bytes, products) of one launch at a recorded
    layout ``key``, as ``_field_bound`` counts it: each operand's distinct
    elements read once (ext_prod: the listed columns of each half), the
    outputs written once, or the products."""
    what, arg, sizes, strides = key
    n = math.prod(sizes)
    if what == "ext_prod":
        rows, cols = sizes[0], len(arg)
        nbytes = sum(8 * (rows * cols if any(st) else 1) for st in strides)
        nbytes += 2 * 8 * rows
        products = rows * 4 * (cols - 1)
    else:
        nbytes = sum(8 * math.prod(z for z, x in zip(sizes, st) if x)
                     for st in strides)
        nbytes += 8 * n * (2 if what in ("ext_mul", "ext_inv") else 1)
        products = n * _field_calls(what, arg)[3]
    ops_ms = products * per_product / MADDS_PER_S * 1e3
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", nbytes, products
    return bytes_ms, "bytes", nbytes, products


def _replay_shares(name, replay, layouts, per_product):
    """Each field kernel's launches and device time in a profiled replay
    beside the sum of its launches' bounds, from the layouts the graph's
    capture recorded."""
    if replay is None:
        say(f"[field] {name}: the replay was not profiled (no device "
            "activity recorded): shares not measured")
        return {}
    bounds = collections.defaultdict(lambda: [0, 0.0])
    for key, count in layouts.items():
        bounds[key[0]][0] += count
        bounds[key[0]][1] += count * _layout_bound(key, per_product)[0]
    out = {}
    for what in ("gl_binary", "gl_pow", "ext_mul", "ext_prod", "ext_inv"):
        n, us = replay["kernels"].get(f"{what}_kernel", (0, 0.0))
        captured, bound_ms = bounds[what]
        ms = us / 1e3
        out[what] = {"launches": n, "captured": captured, "device_ms": ms,
                     "bound_ms": bound_ms,
                     "share": bound_ms / ms if ms else None}
        say(f"[field] {name}: {what}_kernel {n} launches ({captured} in the "
            f"capture's layouts), {ms:.4f} ms of device time, sum of the "
            f"launches' bounds {bound_ms:.4f} ms"
            + (f", {bound_ms / ms:.1%} of bound" if ms else ""))
    for k, (n, us) in sorted(replay["paths"].items()):
        say(f"[field] {name}: {k} {n} launches, {us / 1e3:.4f} ms")
    return out


def phase_field(main_launches, seen, kernel_path, captured, replays):
    """Each field kernel against its plain twin on the card, bit for bit,
    at the main path's shapes, then at every layout the paths gave it
    (``seen``, ``kernel_path``, from ``field_layouts``), with its device
    time, the twin's and the card's bound; the paths the kernels took; the
    wrappers' host time; each field kernel's share of its bound in the
    profiled fused replays (``replays``: name -> (profile, prover path of
    its capture)).  Returns one record per kernel and timed shape."""
    from tpu_acir_prover_torch.field import gl_plain
    from tpu_acir_prover_torch.kernels import field as kf
    from tpu_acir_prover_torch.kernels.bench import field_input
    from tpu_acir_prover_torch.kernels.field_bench import host_us
    rng = np.random.default_rng(2025)
    dev = torch.device("cuda")
    per_product, instructions = _sass_per_product()
    say(f"[field] one Goldilocks product in field.cu: {per_product} "
        f"IMAD-class of {instructions} SASS instructions (cuobjdump); an "
        f"inverse is {INV_PRODUCTS} products (gl_inv's addition chain)")
    host = host_us(rng, dev)
    say("[field] wrapper host time per call (calls back to back, no "
        "synchronisation): " + ", ".join(
            f"{k} {v:.2f} us" for k, v in host.items()))

    def col(n, c):
        return field_input(rng, (n, c), dev)

    def ntt_views():
        h, c = FIELD_NTT_HALF, FIELD_NTT_COLS
        v = col(FIELD_NTT_ROWS, c).reshape(-1, 2, 2, h, c)
        tw = field_input(rng, (h,), dev).reshape(1, h, 1)
        return v[:, 0, 0], v[:, 0, 1], tw

    def ext_cols():
        n, w = FIELD_TRACE_ROWS, FIELD_WIRES
        x0, x1, y0, y1 = (col(n, w) for _ in range(4))
        return (x0[:, 3], x1[:, 3], y0[:, 5], y1[:, 5])

    def lookup_factors():
        n, w = FIELD_TRACE_ROWS, FIELD_WIRES
        return (col(n, w), field_input(rng, (), dev).expand(n, w))

    def perm_factors():
        n, w = FIELD_TRACE_ROWS, FIELD_WIRES
        return (col(n, w), col(n, w))

    ntt = {}

    def ntt_mul():
        a, b, tw = ntt_views()
        ntt["a"], ntt["t"] = a, kf.mul(b, tw)
        return (b, tw)

    # (kernel, op, exponent or columns, shape, make the operands)
    cases = [
        ("gl_binary", "mul", "(2^20, 43) x (2^20, 1): a column of "
         "coset-shift powers", lambda: (col(FIELD_ROWS, 43),
                                        col(FIELD_ROWS, 1))),
        ("gl_binary", "mul", "NTT radix-4 pass at 2^23 rows x 8 columns, "
         "h = 2^10: v[:, 0, 1] of (-1, 2, 2, h, 8) x the (1, h, 1) "
         "twiddles", ntt_mul),
        ("gl_binary", "add", "NTT radix-4 pass at 2^23 rows: v[:, 0, 0] + "
         "the product (contiguous)", lambda: (ntt["a"], ntt["t"])),
        ("gl_binary", "sub", "NTT radix-4 pass at 2^23 rows: v[:, 0, 0] - "
         "the product (contiguous)", lambda: (ntt["a"], ntt["t"])),
        ("gl_pow", gl_plain.P - 2, "(2^18,): a quotient chunk's l1 "
         "denominators, e = p - 2",
         lambda: (col(FIELD_CHUNK, 1).reshape(-1),)),
        ("ext_mul", None, "(2^17,) ext columns of (2^17, 16) pairs "
         "(stride 16): round 2's chained products", ext_cols),
        ("ext_prod", tuple(range(6)), "(2^17, 16) ext pair, columns 0-5: "
         "round 2's permutation group product", perm_factors),
        ("ext_prod", (0, 1, 2), "(2^17, 16) ext pair, lam1 broadcast, "
         "columns 0-2: a lookup group's product without one column",
         lookup_factors),
        ("ext_inv", None, "(2^17, 16): round 2's lookup factors (lam0 - w, "
         "lam1 broadcast)", lookup_factors),
    ]
    records = []

    def record(name, op, shape, x, kern, twin, products, path, extra,
               bound=None):
        what = f"{name} ({op}) {shape}"
        err, n, outs, ms, plain_ms, method = _hold_field(
            x, kern, twin, what, f"{name}_kernel")
        bound_ms, bound_by, nbytes = _field_bound(x, n, outs, products,
                                                  per_product)
        if bound:       # ext_prod: the listed columns, not whole halves
            bound_ms, bound_by, nbytes = bound[:3]
        say(f"[field] {what}: bit-identical to the plain twin; kernel "
            f"{ms:.4f} ms (device), plain {plain_ms:.2f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound; "
            f"main path: {main_launches[name]} launches; timed by "
            f"{method}")
        records.append({
            "name": name, "route": "cuda", "source": FIELD_SOURCE,
            "replaces": FIELD_REPLACES[op], "launches": main_launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape, "op": op, "path": path,
            "launches_in": "the CLI's run (one eager proof, then the graph's "
            "capture)", "bound_kind": "throughput", "bytes": nbytes,
            "products": n * products, "sass_per_product": per_product,
            "ms_method": f"{method} (kernels/field_bench.device_ms)",
            **extra})

    for name, arg, shape, make in cases:
        op, kern, twin, products = _field_calls(name, arg)
        x = list(make())
        extra, bound = {}, None
        if name == "ext_prod":
            key = (name, arg, tuple(x[0].shape),
                   (tuple(x[0].stride()), tuple(x[1].stride())))
            bound = _layout_bound(key, per_product)
            extra = {"columns": list(arg)}
            x = tuple(x)
        elif name in ("gl_binary", "ext_mul"):
            _, sizes, strides = kf.layout(*x)
            extra = {"kernel_path": kf.PATHS[kf.plan(
                sizes, strides, name == "gl_binary")[0]]}
        record(name, op, shape, x, kern, twin, products,
               "main: the CLI's ECDSA prove", extra, bound)
    ntt.clear()

    # every recorded layout, its operands read through it from one pool of
    # values, each operand from a region of its own (so that no operand's
    # reads hit another's in the cache); a class is (kernel, op, path in the
    # kernel, rank, broadcast dimensions of each operand)
    if not seen:
        raise AssertionError("the paths recorded no field kernel launch")
    span = max(1 + sum((s - 1) * x for s, x in zip(sizes, st))
               for _, _, sizes, strides in seen for st in strides)
    pool = field_input(rng, (4 * span,), dev)     # at most 4 operands
    classes = collections.defaultdict(list)
    for key in seen:
        what, arg, sizes, strides = key
        zero = tuple(tuple(x == 0 for x in st) for st in strides)
        kpath = kernel_path[key]
        classes[(what, str(arg) if what == "ext_prod" else arg, kpath,
                 len(sizes), zero)].append(key)
    t0 = time.perf_counter()
    for cls, keys in sorted(classes.items(), key=lambda kv: str(kv[0])):
        keys.sort(key=lambda k: math.prod(k[2]))
        what, _, kpath = cls[:3]

        def operands(key):
            x = [torch.as_strided(pool, key[2], st, k * span)
                 for k, st in enumerate(key[3])]
            if what == "ext_prod":
                return tuple(x)
            if kf.layout(*x)[1:] != (list(key[2]), [list(s) for s in key[3]]):
                raise AssertionError(f"{key}: the operands' layout is "
                                     f"{kf.layout(*x)[1:]}")
            return x

        for key in keys[:-1]:
            op, kern, twin, _ = _field_calls(what, key[1])
            _hold_field(operands(key), kern, twin, f"{what} ({op}) {key[2:]}")
        key = keys[-1]
        op, kern, twin, products = _field_calls(what, key[1])
        sizes, strides = key[2:]
        x = operands(key)
        calls = collections.Counter()
        for k in keys:
            calls.update(seen[k])
        say(f"[field] {what} ({op}) path {kpath} rank {len(sizes)}: "
            f"{len(keys)} recorded layouts bit-identical to the plain twin; "
            f"calls by path {dict(calls)}")
        extra = {"layouts_in_class": len(keys),
                 "calls_at_layout": dict(seen[key]),
                 "calls_in_class": dict(calls), "kernel_path": kpath}
        bound = None
        if what == "ext_prod":
            extra["columns"] = list(key[1])
            bound = _layout_bound(key, per_product)
        record(what, op, f"recorded layout: sizes {list(sizes)}, strides "
               f"{[list(st) for st in strides]}", x, kern, twin, products,
               ", ".join(sorted(seen[key])), extra, bound)
        del x
    say(f"[field] {len(seen)} recorded layouts in {len(classes)} classes "
        f"held in {time.perf_counter() - t0:.1f} s")
    methods = collections.Counter(r["ms_method"] for r in records)
    say(f"[field] device times of {len(records)} records by method: "
        f"{dict(methods)}")

    # the kernels' paths by prover path, and the general path's launches:
    # at rank 1 (a strided column) by design, above rank 1 unexpected
    by_path = collections.defaultdict(collections.Counter)
    large_general = collections.defaultdict(collections.Counter)
    for key, counts in seen.items():
        kpath = kernel_path[key]
        for prover, n in counts.items():
            by_path[prover][f"{key[0]}/{kpath}"] += n
            if kpath == "general" and key[0] in ("gl_binary", "ext_mul") \
                    and math.prod(key[2]) >= GENERAL_LARGE:
                rank = "rank 1" if len(key[2]) == 1 else "rank > 1"
                large_general[prover][rank] += n
    for prover, counts in by_path.items():
        say(f"[field] kernel paths in {prover}: {dict(sorted(counts.items()))}"
            f"; gl_binary and ext_mul launches on the general path at >= "
            f"{GENERAL_LARGE} elements: strided rank-1 columns "
            f"{large_general[prover]['rank 1']}, above rank 1 "
            f"{large_general[prover]['rank > 1']}")

    for name, (replay, prover) in replays.items():
        shares = _replay_shares(name, replay, captured.get(prover, {}),
                                per_product)
        records_note = {"replay": name, **{k: v for k, v in shares.items()}}
        say(f"[field] {name} shares: {json.dumps(records_note)}")
    return records


def _small_circuits():
    from tpu_acir_prover_torch.acir.translator import translate_program
    from tpu_acir_prover_torch.circuit.builder import CircuitBuilder
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    from tpu_acir_prover_torch.utils import circuits
    prog, wm = circuits.fibonacci()
    tr = translate_program(prog)
    yield "fibonacci", compile_circuit(tr.builder), tr.external_values(wm)
    b = CircuitBuilder(lookup_bits=8)
    x = b.add_external()
    b.range_check(x, 8)
    y = b.add_external()
    b.range_check(y, 5)
    z = b.add_external()
    b.range_check(z, 19)
    yield "lookup_bits=8", compile_circuit(b), \
        np.array([200, 31, (1 << 19) - 3], dtype=np.uint64)


def phase_parity():
    from tpu_acir_prover_torch.prover.config import TEST_CONFIG
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.prover.serialization import serialize_proof
    from tpu_acir_prover_torch.prover.verify import verify
    for name, cc, ext in _small_circuits():
        want = serialize_proof(prove(ProvingKey(cc, TEST_CONFIG, device="cpu"),
                                     ext))
        pk = ProvingKey(cc, TEST_CONFIG, device="cuda")
        proof = prove(pk, ext)
        verify(pk.vk, proof)
        fused = prove_fused(pk, ext)
        verify(pk.vk, fused)
        if serialize_proof(proof) != want or serialize_proof(fused) != want:
            raise AssertionError(f"{name}: proof bytes on the card differ "
                                 "from those on the CPU")
        say(f"[parity] {name} n={cc.n}: {len(want)} proof bytes on the card, "
            "per-phase and fused (a CUDA graph replay), equal to the port's "
            "on the CPU (plain twins); both verified")


def phase_main_path(work):
    """The port's CLI on the ECDSA circuit; returns the kernels' launch
    counts over that run (the eager warm-up run and the capture of the
    fused path), the proving key, the external values and the proof."""
    from tpu_acir_prover_torch import api, cli
    from tpu_acir_prover_torch.acir import codec
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
    from tpu_acir_prover_torch.utils import circuits

    prog_path, wit_path = _save_program(work, "ecdsa",
                                        *circuits.ecdsa_secp256k1())
    proof_path = os.path.join(work, "proof")
    vk_path = os.path.join(work, "vk")

    reset_launches()
    t0 = time.perf_counter()
    if cli.main(["prove", "-b", prog_path, "-w", wit_path, "-o", proof_path,
                 "--device", "cuda"]) != 0:
        raise AssertionError("cli prove failed")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = all_launches()
    if cli.main(["write_vk", "-b", prog_path, "-o", vk_path,
                 "--device", "cuda"]) != 0:
        raise AssertionError("cli write_vk failed")
    if cli.main(["verify", "-k", vk_path, "-p", proof_path]) != 0:
        raise AssertionError("cli verify rejected the proof")
    tr, pk = api.load_and_compile(prog_path, STANDARD_CONFIG, "cuda")
    say(f"[main] ecdsa_secp256k1 n=2^{pk.compiled.log_n} "
        f"LDE=2^{pk.m.bit_length() - 1}: cli prove (proving key build "
        f"included) {cold_s:.3f} s, write_vk and verify ok; "
        f"launches {launches} (two_to_one_level: "
        f"{launches['two_to_one_level']})")
    missing = [k for k, v in launches.items() if v == 0 and k not in OFF_PATH]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if pk._captured is None:
        raise AssertionError("the CLI did not prove through a CUDA graph")
    say("[main] the CLI took the fused path: one CUDA graph captured for "
        "the key and replayed")
    data = _verify_flipped(vk_path, proof_path, "[main]")
    ws = codec.load_witness_stack(wit_path)
    return launches, pk, tr.external_values(ws.peek().witness), data


def _verify_flipped(vk_path, proof_path, phase):
    """The port's verifier on the CLI's files: it accepts the proof and
    rejects it with a byte flipped.  Returns the proof's bytes."""
    from tpu_acir_prover_torch.prover.compress import decompress_proof
    from tpu_acir_prover_torch.prover.serialization import (
        deserialize_compressed_proof, deserialize_vk)
    from tpu_acir_prover_torch.prover.verify import verify
    with open(vk_path, "rb") as f:
        vk = deserialize_vk(f.read())
    with open(proof_path, "rb") as f:
        data = f.read()
    verify(vk, decompress_proof(vk, deserialize_compressed_proof(data)))
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0x01
    try:
        verify(vk, decompress_proof(vk, deserialize_compressed_proof(
            bytes(bad))))
    except Exception as e:  # any failure is a rejection
        say(f"{phase} port's verifier: accepts the proof, rejects it with "
            f"byte {len(bad) // 2} flipped ({type(e).__name__})")
    else:
        raise AssertionError("tampered proof was accepted")
    return data


def _median(xs):
    """The median; of an even count, the upper one."""
    return sorted(xs)[len(xs) // 2]


def phase_fused(pk, ext, data):
    """The captured graph of the CLI's proof, then warm fused and per-phase
    proofs in turns, their synchronising calls, and one profiled replay.
    Returns the (state, lane) the per-phase proof's grind searched from,
    the per-phase proofs' summary and the replay's profile."""
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.prove import prove
    from tpu_acir_prover_torch.utils.syncs import count_syncs

    cap = pk._captured
    say(f"[fused] one CUDA graph for the proof after witness_fill: capture "
        f"{cap.capture_s:.3f} s, instantiate {cap.instantiate_s:.3f} s, pool "
        f"{cap.pool_bytes / 2**30:.3f} GiB kept between replays; kernel "
        f"launches per replay {cap.launches}")
    missing = [k for k, v in cap.launches.items()
               if v == 0 and k not in OFF_PATH]
    if missing:
        raise AssertionError(f"the captured graph holds no {missing}")
    ext_launches = cap.launches["ext_mul"] + cap.launches["ext_prod"]
    say(f"[fused] ext_mul + ext_prod launches a replay: "
        f"{cap.launches['ext_mul']} + {cap.launches['ext_prod']} = "
        f"{ext_launches} (ext_mul alone before ext_prod: "
        f"{EXT_MUL_REPLAY_BEFORE})")
    if ext_launches >= EXT_MUL_REPLAY_BEFORE:
        raise AssertionError("ext_prod did not take launches off the replay")
    per_phase, seen = _in_turns(pk, ext, data, "[fused]")
    _, n_fused = count_syncs(lambda: prove_fused(pk, ext))
    _, n_phase = count_syncs(lambda: prove(pk, ext))
    say(f"[fused] synchronising calls per proof (sync debug mode): fused "
        f"{n_fused}, per-phase {n_phase}")
    replay = profile_replay(pk, ext)
    return seen[0], per_phase, replay


def _in_turns(pk, ext, data, phase):
    """Warm fused and per-phase proofs on the CLI's key in turns,
    ALTERNATIONS of each, each one's bytes equal to the CLI's ``data``;
    prints each with its phases, peak and (per-phase: the fused proof's are
    the capture's) kernel launches counted from 0, then the upper medians.
    Returns the per-phase proofs' median, peak and last phases, and the
    (state, lane) each per-phase proof's grind searched from."""
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.prover.compress import compress_proof
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.prove import prove
    from tpu_acir_prover_torch.prover.serialization import (
        serialize_compressed_proof)
    from tpu_acir_prover_torch.utils.timing import PhaseTimer

    seen = []
    real_grind = kp.grind

    def spy(state, lane, pow_bits, inputs=()):
        seen.append((state.clone(), lane))
        return real_grind(state, lane, pow_bits, inputs)

    times = {"fused": [], "per-phase": []}
    peaks = {"fused": [], "per-phase": []}
    phase_ms = {"fused": [], "per-phase": []}
    provers = {"fused": prove_fused, "per-phase": prove}
    runs = [name for i in range(ALTERNATIONS) for name in
            (("fused", "per-phase") if i % 2 == 0 else ("per-phase", "fused"))]
    for name in runs:
        timer = PhaseTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        kp.grind = spy   # the per-phase proof calls it; a replay does not
        try:
            t0 = time.perf_counter()
            proof = provers[name](pk, ext, timer=timer)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            kp.grind = real_grind
        launches = f"; launches {all_launches()}" \
            if name == "per-phase" else ""
        times[name].append(dt)
        peaks[name].append(torch.cuda.max_memory_allocated())
        if serialize_compressed_proof(compress_proof(pk.vk, proof)) != data:
            raise AssertionError(f"{name} proof differs from the CLI's")
        phases = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.phases)
        phase_ms[name].append(phases)
        say(f"{phase} warm {name} proof {dt:.3f} s ({phases}); peak "
            f"allocated {peaks[name][-1] / 2**30:.3f} GiB; bytes equal to "
            f"the CLI's{launches}")
    say(f"{phase} medians of {ALTERNATIONS}: fused "
        f"{_median(times['fused']):.3f} s, per-phase "
        f"{_median(times['per-phase']):.3f} s; peak allocated fused "
        f"{max(peaks['fused']) / 2**30:.3f} GiB (the graph's pool is "
        f"reserved apart: {pk._captured.pool_bytes / 2**30:.3f} GiB), "
        f"per-phase {max(peaks['per-phase']) / 2**30:.3f} GiB")
    per_phase = {"median_s": _median(times["per-phase"]),
                 "peak_gib": max(peaks["per-phase"]) / 2**30,
                 "phases": phase_ms["per-phase"][-1]}
    return per_phase, seen


def profile_replay(pk, ext, tag="[fused]"):
    """One replay of the captured graph under torch.profiler: its device
    operations and device time; the idle share is one minus the device
    time over the unprofiled replay's wall time.  Returns the Poseidon2 and
    field kernels' {"kernels": {name: (count, us)}, "paths": {field kernel
    and path: (count, us)}}, None where the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_acir_prover_torch.kernels.field_bench import device_totals
    cc = pk.compiled
    vals = cc.generate_witness(ext)
    pub = np.array(cc.public_values(vals), dtype=np.uint64)
    mcol = cc.multiplicities(cc.wire_values(vals)) if pk.has_lookups \
        else None
    cap = pk._captured
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap.run(vals, pub, mcol)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cap.run(vals, pub, mcol)
        torch.cuda.synchronize()
    total_us, total_n, ours, paths = device_totals(
        prof, POSEIDON_KERNELS + FIELD_KERNELS)
    if not total_n:
        say(f"{tag} the profiler recorded no device activity: device time "
            "and idle share not measured")
        return None
    wall = _median(walls)
    per = ", ".join(f"{k} {n} x = {t / 1e3:.4f} ms" for k, (n, t) in
                    ours.items())
    say(f"{tag} one replay (inputs in, replay, outputs out): wall "
        f"{wall * 1e3:.1f} ms (median of 3); under the profiler "
        f"{total_n} device operations, {total_us / 1e3:.1f} ms of device "
        f"time, idle share {1 - total_us / 1e6 / wall:.1%}; Poseidon2 and "
        f"field kernels in the replay (count = device time): {per}; field "
        f"kernels by path: " + ", ".join(
            f"{k} {n} x = {t / 1e3:.4f} ms" for k, (n, t) in
            sorted(paths.items())) +
        f"; wrapper counts the capture recorded: {cap.launches}")
    return {"kernels": {k: tuple(v) for k, v in ours.items()},
            "paths": {k: tuple(v) for k, v in paths.items()}}


def profile_proof(pk, ext):
    """One warm per-phase proof under torch.profiler (device activity
    only): the device time and count of all kernels and of the Poseidon2
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_acir_prover_torch.kernels.field_bench import device_totals
    from tpu_acir_prover_torch.prover.prove import prove
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prove(pk, ext)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    total_us, total_n, ours, _ = device_totals(
        prof, POSEIDON_KERNELS + FIELD_KERNELS)
    if not total_n:
        say("[profile] the profiler recorded no device activity: device time "
            "not measured")
        return
    poseidon_ms = sum(ours[k][1] for k in POSEIDON_KERNELS) / 1e3
    field_ms = sum(ours[k][1] for k in FIELD_KERNELS) / 1e3
    per = ", ".join(f"{k} {n} x {t / 1e3:.3f} ms" for k, (n, t) in ours.items())
    say(f"[profile] warm per-phase prove under the profiler {wall_s:.3f} s: "
        f"{total_n} device operations, {total_us / 1e3:.1f} ms of device "
        f"time; Poseidon2 kernels {poseidon_ms:.3f} ms, field kernels "
        f"{field_ms:.3f} ms ({per})")


def _timed_proof(prover, key, ext, tag, log):
    """One warm proof: (proof, seconds, phases, peak allocated GiB, the
    kernels' launches in it, counted from 0); the kernels' shapes go to
    ``log``."""
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.utils.timing import PhaseTimer
    timer = PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with shapes_seen(log):
        proof = prover(key, ext, timer=timer)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    missing = [k for k in SHARDED_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag} launched no {missing}")
    phases = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.phases)
    return proof, dt, phases, torch.cuda.max_memory_allocated() / 2**30, \
        launches


def _built(make, tag, log, before=None):
    """A proving key from ``make()``; prints its build time and peak, and
    ``before``, an earlier peak to hold it against.  The kernels' shapes
    (the constants oracle's commit) go to ``log``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with shapes_seen(log):
        key = make()
    torch.cuda.synchronize()
    say(f"[sharded] {tag}: key built in {time.perf_counter() - t0:.3f} s, "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        "GiB" + (f" ({before})" if before else ""))
    return key


def phase_sharded(pk, ext, data, per_phase):
    """prove_sharded with every shard on cuda:0: parity on the small
    circuits, the ECDSA circuit over 4 shards beside the single-device
    per-phase proof.  Returns that path: the kernels' launches in one
    proof, the shapes they were given, the LDE rows per shard."""
    from tpu_acir_prover_torch.parallel.mesh import Mesh
    from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                      prove_sharded)
    from tpu_acir_prover_torch.prover.compress import compress_proof
    from tpu_acir_prover_torch.prover.config import (STANDARD_CONFIG,
                                                     TEST_CONFIG)
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.prover.serialization import (
        serialize_compressed_proof, serialize_proof)
    from tpu_acir_prover_torch.prover.verify import verify

    for name, cc, small_ext in _small_circuits():
        want = serialize_proof(prove(ProvingKey(cc, TEST_CONFIG, device="cpu"),
                                     small_ext))
        for shards in SHARDS_SMALL:
            spk = ShardedProvingKey(cc, TEST_CONFIG,
                                    mesh=Mesh.on("cuda:0", shards))
            proof = prove_sharded(spk, small_ext)
            verify(spk.vk, proof)
            if serialize_proof(proof) != want:
                raise AssertionError(f"{name}: sharded proof over {shards} "
                                     "shards differs from the CPU's")
        say(f"[sharded] {name} n={cc.n}: prove_sharded over "
            f"{' and '.join(map(str, SHARDS_SMALL))} shards on cuda:0, "
            f"{len(want)} bytes equal to the port's on the CPU; verified")

    tag = f"ecdsa_secp256k1 2^{pk.compiled.log_n} over {SHARDS} shards"
    log = collections.Counter()
    spk = _built(lambda: ShardedProvingKey(pk.compiled, STANDARD_CONFIG,
                                           mesh=Mesh.on("cuda:0", SHARDS)),
                 tag, log)
    if spk.vk.constants_cap != pk.vk.constants_cap:
        raise AssertionError("sharded constants cap differs")
    proof, dt, phases, peak, launches = _timed_proof(prove_sharded, spk, ext,
                                                     tag, log)
    if serialize_compressed_proof(compress_proof(spk.vk, proof)) != data:
        raise AssertionError(f"{tag}: proof differs from the CLI's")
    verify(spk.vk, proof)
    say(f"[sharded] {tag}: warm proof {dt:.3f} s ({phases}); peak "
        f"allocated {peak:.3f} GiB; Poseidon2 launches {launches}; bytes "
        "equal to the CLI's; verified")
    say(f"[sharded] {tag}: beside it the single-device per-phase proof "
        f"(median of "
        f"{ALTERNATIONS} in [fused]) {per_phase['median_s']:.3f} s, "
        f"peak {per_phase['peak_gib']:.3f} GiB ({per_phase['phases']})")
    return {"path": tag, "launches": launches, "launches_in": "one proof",
            "shapes": log, "rows": spk.m // SHARDS}


def _fused_on_key(pk, ext, want, tag, phase):
    """``prove_fused`` on a 2^20-row key that proved per-phase: the first
    proof (an eager run, the graph's capture and instantiation, a replay),
    then a warm one; bytes equal to the per-phase proof's ``want``,
    verified.  Returns the path, with one replay's kernel launches (the
    capture's count)."""
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.serialization import serialize_proof
    from tpu_acir_prover_torch.prover.verify import verify
    from tpu_acir_prover_torch.utils.timing import PhaseTimer

    ftag = f"{tag} fused on one device"
    log = collections.Counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with shapes_seen(log):
        first = prove_fused(pk, ext)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_peak = torch.cuda.max_memory_allocated() / 2**30
    cap = pk._captured
    if cap is None:
        raise AssertionError(f"{ftag}: no CUDA graph was captured")
    missing = [k for k in FUSED_PATH if cap.launches[k] == 0]
    if missing:
        raise AssertionError(f"{ftag}: the graph holds no {missing}")
    say(f"{phase} {ftag}: first proof {cold_s:.3f} s (eager run, capture "
        f"{cap.capture_s:.3f} s, instantiate {cap.instantiate_s:.3f} s, one "
        f"replay), peak allocated {cold_peak:.3f} GiB; graph pool "
        f"{cap.pool_bytes / 2**30:.3f} GiB kept between replays; kernel "
        f"launches a replay (the capture's count) {cap.launches}")
    timer = PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = prove_fused(pk, ext, timer=timer)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for p in (first, proof):
        verify(pk.vk, p)
        if serialize_proof(p) != want:
            raise AssertionError(f"{ftag}: bytes differ from the per-phase "
                                 "proof's")
    phases = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.phases)
    say(f"{phase} {ftag}: warm proof {dt:.3f} s ({phases}); peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"besides the pool; both proofs' bytes equal to the per-phase "
        f"proof's; verified")
    replay = profile_replay(pk, ext, f"{phase} {ftag}:")
    pk._captured = None
    return {"path": ftag, "launches": cap.launches,
            "launches_in": "one replay (the capture's count)", "shapes": log,
            "rows": pk.m, "replay": replay}


def phase_sha256():
    """The SHA-256 circuits on the card: the parity circuit, the 2^17-row
    two-block message through the CLI, the 2^20-row chained message through
    ``api`` and the fused prover.  Returns their paths, as
    ``phase_sharded`` does."""
    t0 = time.perf_counter()
    _release("[sha256] at the start")
    paths = [_sha256_parity()]
    with tempfile.TemporaryDirectory() as work:
        _release("[sha256] after the parity proofs")
        cli_path, cli_rows = _sha256_cli(work)
        paths.append(cli_path)
        _release("[sha256] after the 2^17 proofs")
        paths += _sha256_long(work, cli_rows)
    _release("[sha256] at the end")
    say(f"[sha256] phase took {time.perf_counter() - t0:.1f} s")
    return paths


def _release(tag):
    """Drops api's cached keys with their graphs, then the cyclic garbage;
    prints what stays allocated on the card before and after, which every
    peak measured next includes."""
    from tpu_acir_prover_torch import api
    api._CACHE.clear()
    before = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    say(f"{tag}: {before:.3f} GiB allocated on the card, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB once the cyclic "
        "garbage is collected")


def _sha256_parity():
    """The one-compression circuit (2^16 rows, test config) proven
    per-phase and fused on the card: bytes equal, both verified.  Returns
    the path of the key build and the per-phase proof."""
    from tpu_acir_prover_torch.acir.translator import translate_program
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.prover.config import TEST_CONFIG
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.prover.serialization import serialize_proof
    from tpu_acir_prover_torch.prover.verify import verify
    from tpu_acir_prover_torch.utils import circuits

    prog, wm = circuits.sha256_compression()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    ext = tr.external_values(wm)
    log = collections.Counter()
    reset_launches()
    t0 = time.perf_counter()
    with shapes_seen(log):
        pk = ProvingKey(cc, TEST_CONFIG, device="cuda")
        proof = prove(pk, ext)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = all_launches()
    fused = prove_fused(pk, ext)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    missing = [k for k in SHARDED_PATH if launches[k] == 0] + \
        [k for k in FUSED_PATH if pk._captured.launches[k] == 0]
    if missing:
        raise AssertionError(f"sha256_compression launched no {missing}")
    data = serialize_proof(proof)
    verify(pk.vk, proof)
    verify(pk.vk, fused)
    if serialize_proof(fused) != data:
        raise AssertionError("sha256_compression: the fused proof's bytes "
                             "differ from the per-phase proof's")
    say(f"[sha256] sha256_compression n=2^{cc.log_n} (test config): "
        f"{len(data)} proof bytes per-phase and fused (a CUDA graph "
        f"replay), equal; both verified; key build and per-phase proof "
        f"{t1 - t0:.3f} s, first fused proof {t2 - t1:.3f} s; the CPU's "
        "bytes are held in tests/test_torch_sha256.py (RUN_SLOW=1): a CPU "
        "proof takes minutes")
    pk._captured = None
    return {"path": "sha256_compression 2^16 (test config)",
            "launches": launches,
            "launches_in": "the key build and one per-phase proof",
            "shapes": log, "rows": pk.m}


def _save_program(work, name, prog, wm):
    """The program's artifact and witness files: their paths."""
    from tpu_acir_prover_torch.acir import codec, ir
    prog_path = os.path.join(work, f"{name}.json")
    wit_path = os.path.join(work, f"{name}.gz")
    codec.save_program_artifact(prog_path, prog)
    codec.save_witness_stack(wit_path, ir.WitnessStack([ir.StackItem(0, wm)]))
    return prog_path, wit_path


def _sha256_cli(work):
    """The CLI's prove, write_vk and verify of sha256_multiblock(2), 2^17
    rows, on the fused path; warm proofs in turns on its key.  Returns the
    path of the CLI's prove and the circuit's builder rows."""
    from tpu_acir_prover_torch import api, cli
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
    from tpu_acir_prover_torch.utils import circuits

    tag = f"sha256_multiblock({SHA_CLI_BLOCKS})"
    prog, wm = circuits.sha256_multiblock(SHA_CLI_BLOCKS)
    prog_path, wit_path = _save_program(work, "sha2", prog, wm)
    proof_path = os.path.join(work, "sha2.proof")
    vk_path = os.path.join(work, "sha2.vk")
    calls, log = {}, collections.Counter()
    reset_launches()
    t0 = time.perf_counter()
    with shapes_seen(log), timed_calls(api, API_CALLS, calls):
        if cli.main(["prove", "-b", prog_path, "-w", wit_path, "-o",
                     proof_path, "--device", "cuda"]) != 0:
            raise AssertionError(f"{tag}: cli prove failed")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = all_launches()
    if cli.main(["write_vk", "-b", prog_path, "-o", vk_path,
                 "--device", "cuda"]) != 0:
        raise AssertionError(f"{tag}: cli write_vk failed")
    if cli.main(["verify", "-k", vk_path, "-p", proof_path]) != 0:
        raise AssertionError(f"{tag}: cli verify rejected the proof")
    tr, pk = api.load_and_compile(prog_path, STANDARD_CONFIG, "cuda")
    cap = pk._captured
    if cap is None or "prove" in calls:
        raise AssertionError(f"{tag}: the CLI did not prove through a CUDA "
                             "graph")
    missing = [k for k in FUSED_PATH if cap.launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: the graph holds no {missing}")
    tag = f"{tag} 2^{pk.compiled.log_n}"
    say(f"[sha256] {tag} LDE=2^{pk.m.bit_length() - 1}: cli prove "
        f"{cold_s:.3f} s: translate {calls['translate_program'][0]:.3f} s, "
        f"compile {calls['compile_circuit'][0]:.3f} s, key build "
        f"{calls['ProvingKey'][0]:.3f} s (peak allocated "
        f"{calls['ProvingKey'][1]:.3f} GiB), first proof "
        f"{calls['prove_fused'][0]:.3f} s (eager run, capture "
        f"{cap.capture_s:.3f} s, instantiate {cap.instantiate_s:.3f} s, one "
        f"replay; peak allocated {calls['prove_fused'][1]:.3f} GiB); "
        f"write_vk and verify ok; graph pool {cap.pool_bytes / 2**30:.3f} "
        f"GiB; launches a replay (the capture's count) {cap.launches}; "
        f"launches in the CLI's run {launches}")
    data = _verify_flipped(vk_path, proof_path, f"[sha256] {tag}:")
    _in_turns(pk, tr.external_values(wm), data, f"[sha256] {tag}:")
    return {"path": f"{tag}: the CLI's prove", "launches": launches,
            "launches_in": "the CLI's run (the key build, one eager proof, "
                           "the graph's capture)",
            "shapes": log, "rows": pk.m}, len(tr.builder.rows)


def _sha256_long(work, cli_rows):
    """The longest chained message that compiles to 2^20 rows: per-phase
    through ``api.prove_file``, then fused on the same key; bytes equal,
    both verified.  Returns the two paths."""
    from tpu_acir_prover_torch import api
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.prover.compress import decompress_proof
    from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
    from tpu_acir_prover_torch.prover.serialization import (
        deserialize_compressed_proof, serialize_proof)
    from tpu_acir_prover_torch.prover.verify import verify
    from tpu_acir_prover_torch.utils import circuits
    from tpu_acir_prover_torch.utils.timing import PhaseTimer

    blocks = circuits.SHA_LONG_BLOCKS
    prog, wm = circuits.sha256_multiblock(blocks)
    prog_path, wit_path = _save_program(work, "sha_long", prog, wm)
    calls, log = {}, collections.Counter()
    timer = PhaseTimer()
    reset_launches()
    with shapes_seen(log), timed_calls(api, API_CALLS, calls):
        data = api.prove_file(prog_path, wit_path,
                              os.path.join(work, "sha_long.proof"),
                              STANDARD_CONFIG, "cuda", timer=timer)
    launches = all_launches()
    tr, pk = api.load_and_compile(prog_path, STANDARD_CONFIG, "cuda")
    tag = f"sha256_multiblock({blocks}) 2^{pk.compiled.log_n}"
    if "prove" not in calls:
        raise AssertionError(f"{tag}: api did not prove per-phase")
    missing = [k for k in SHARDED_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: api's proof launched no {missing}")
    rows = len(tr.builder.rows)
    per_block = (rows - cli_rows) // (blocks - SHA_CLI_BLOCKS)
    if pk.n != 1 << 20 or rows + per_block <= pk.n:
        raise AssertionError(f"{blocks} blocks are not the most that "
                             "compile to 2^20 rows")
    proof = decompress_proof(pk.vk, deserialize_compressed_proof(data))
    verify(pk.vk, proof)
    want = serialize_proof(proof)
    del proof
    phases = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.phases)
    say(f"[sha256] {tag} LDE=2^{pk.m.bit_length() - 1}: {rows} builder "
        f"rows ({rows / pk.n:.1%} of the trace; {blocks + 1} blocks would "
        f"take {rows + per_block}); translate "
        f"{calls['translate_program'][0]:.3f} s, compile "
        f"{calls['compile_circuit'][0]:.3f} s, key built in "
        f"{calls['ProvingKey'][0]:.3f} s, peak allocated "
        f"{calls['ProvingKey'][1]:.3f} GiB")
    say(f"[sha256] {tag} per-phase through api.prove_file: proof "
        f"{calls['prove'][0]:.3f} s ({phases}); peak allocated "
        f"{calls['prove'][1]:.3f} GiB; launches (the key build and the "
        f"proof) {launches}; verified")
    paths = [{"path": f"{tag} per-phase through api.prove_file",
              "launches": launches,
              "launches_in": "api.prove_file (the key build and one "
                             "per-phase proof)",
              "shapes": log, "rows": pk.m}]
    paths.append(_fused_on_key(pk, tr.external_values(wm), want, tag,
                               "[sha256]"))
    return paths


def phase_scaling():
    """The weak-scaling sweep of parallel/scaling.py at its default size
    with one timed proof a point (``SCALING_REPS``), all
    shards on cuda:0, its kernels' launches counted from 0; each point's
    last proof verified, the largest point's bytes equal to the port's on
    the CPU.
    Returns the sweep as a path, as ``phase_sharded`` does: every point
    has the same LDE rows a shard."""
    from tpu_acir_prover_torch.kernels import poseidon as kp
    from tpu_acir_prover_torch.parallel import scaling
    from tpu_acir_prover_torch.prover.config import TEST_CONFIG
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.prover.serialization import serialize_proof
    from tpu_acir_prover_torch.prover.verify import verify

    points, log = [], collections.Counter()
    reset_launches()
    t0 = time.perf_counter()
    with shapes_seen(log):
        line = scaling.sweep(
            "cuda:0", scaling.LOG_PER_SHARD, SCALING_REPS,
            check=lambda spk, proof: points.append(
                (len(spk.mesh.devices), spk.compiled, spk.vk, proof)))
    launches = all_launches()
    sweep_s = time.perf_counter() - t0
    missing = [k for k in SHARDED_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"the scaling sweep launched no {missing}")
    for _, _, vk, proof in points:
        verify(vk, proof)
    shards, cc, _, proof = points[-1]
    t0 = time.perf_counter()
    want = serialize_proof(prove(ProvingKey(cc, TEST_CONFIG, device="cpu"),
                                 np.array([], dtype=np.uint64)))
    if serialize_proof(proof) != want:
        raise AssertionError(f"scaling sweep over {shards} shards: bytes "
                             "differ from the port's on the CPU")
    counts = ", ".join(str(p[0]) for p in points)
    say(f"[scaling] {json.dumps(line)}")
    say(f"[scaling] sweep took {sweep_s:.1f} s; launches {launches}; the "
        f"last proof of each point ({counts} shards) verified; the last "
        f"over {shards} shards equal to the port's on the CPU (proven there "
        f"in {time.perf_counter() - t0:.1f} s)")
    return {"path": f"scaling sweep (2^{scaling.LOG_PER_SHARD} rows a shard, "
                    f"S = {counts} on cuda:0)",
            "launches": launches,
            "launches_in": "the sweep (each point's key build, warm-up and "
                           f"{SCALING_REPS} timed proof)",
            "shapes": log,
            "rows": 1 << (scaling.LOG_PER_SHARD + TEST_CONFIG.rate_bits)}


def phase_mul_chain():
    """The 2^20-row mul_chain circuit (bench.py's headline) at
    STANDARD_CONFIG: one per-phase proof on a plain key, the fused prover
    on the same key, one prove_sharded over SHARDS shards on cuda:0 (over 2
    if that runs out of memory); the bytes equal, all verified.  Returns
    the three paths, as ``phase_sharded`` does."""
    from tpu_acir_prover_torch.parallel.mesh import Mesh
    from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                      prove_sharded)
    from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.prover.serialization import serialize_proof
    from tpu_acir_prover_torch.prover.verify import verify
    from tpu_acir_prover_torch.utils.bench_circuits import mul_chain_circuit

    cc = mul_chain_circuit(MUL_CHAIN_LOG_N)
    ext = np.array([], dtype=np.uint64)
    tag = f"mul_chain 2^{MUL_CHAIN_LOG_N}"
    log = collections.Counter()
    pk = _built(lambda: ProvingKey(cc, STANDARD_CONFIG, device="cuda"),
                f"{tag} on one device", log,
                f"{UNBLOCKED_PEAKS_GIB['key']} GiB before column blocks")
    proof, dt, phases, peak, launches = _timed_proof(prove, pk, ext, tag, log)
    paths = [{"path": f"{tag} per-phase on one device",
              "launches": launches, "launches_in": "one proof", "shapes": log,
              "rows": pk.m}]
    verify(pk.vk, proof)
    want = serialize_proof(proof)
    say(f"[sharded] {tag} per-phase on one device: proof {dt:.3f} s "
        f"({phases}); peak allocated {peak:.3f} GiB "
        f"({UNBLOCKED_PEAKS_GIB['proof']} GiB before column blocks); "
        f"launches {launches}; verified")
    del proof
    paths.append(_fused_on_key(pk, ext, want, tag, "[sharded]"))
    del pk
    torch.cuda.empty_cache()
    for shards in (SHARDS, 2):
        stag = f"{tag} over {shards} shards"
        log = collections.Counter()
        try:
            spk = _built(lambda: ShardedProvingKey(
                cc, STANDARD_CONFIG, mesh=Mesh.on("cuda:0", shards)), stag,
                log)
            proof, dt, phases, peak, launches = _timed_proof(
                prove_sharded, spk, ext, stag, log)
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0]
        else:
            verify(spk.vk, proof)
            if serialize_proof(proof) != want:
                raise AssertionError(f"{stag}: bytes differ from one "
                                     "device's")
            say(f"[sharded] {stag}: proof {dt:.3f} s ({phases}); peak "
                f"allocated {peak:.3f} GiB; launches {launches}; bytes "
                "equal to the one-device proof; verified")
            return paths + [{"path": stag, "launches": launches,
                             "launches_in": "one proof", "shapes": log,
                             "rows": spk.m // shards}]
        spk = proof = None
        say(f"[sharded] {stag}: out of memory at peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB: {err}")
        torch.cuda.empty_cache()
    raise AssertionError(f"{tag}: no sharded proof fitted the card")


def main():
    smi = phase_device()
    phase_build()
    # every field kernel launch of the paths below, by layout and path;
    # those made while a graph was captured, by path and layout
    seen = collections.defaultdict(collections.Counter)
    captured = collections.defaultdict(collections.Counter)
    kernel_path = {}
    with field_layouts(seen, captured, kernel_path) as on_path:
        on_path("parity")
        phase_parity()
        on_path("main")
        with tempfile.TemporaryDirectory() as work:
            launches, pk, ext, data = phase_main_path(work)
        on_path("fused")
        (grind_state, grind_lane), per_phase, ecdsa_replay = phase_fused(
            pk, ext, data)
        profile_proof(pk, ext)
        t0 = time.perf_counter()
        on_path("sharded")
        paths = [phase_sharded(pk, ext, data, per_phase)]
        # the CLI's key and its graph's pool are not needed any more
        from tpu_acir_prover_torch import api
        api._CACHE.clear()
        del pk
        torch.cuda.empty_cache()
        on_path("mul_chain")
        paths += phase_mul_chain()
        say(f"[sharded] phase took {time.perf_counter() - t0:.1f} s; then, "
            f"with no garbage collected, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on "
            "the card (the dropped sharded keys freed at once)")
        torch.cuda.empty_cache()
        on_path("sha256")
        paths += phase_sha256()
        on_path("scaling")
        paths.append(phase_scaling())
    t0 = time.perf_counter()
    chain = next(p for p in paths if "replay" in p)
    replays = {"fused ECDSA replay": (ecdsa_replay, "main"),
               f"{chain['path']} replay": (chain["replay"], "mul_chain")}
    records = phase_field(launches, seen, kernel_path, captured, replays)
    say(f"[field] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records += phase_kernels(grind_state, grind_lane, launches, paths)
    say(f"[kernels] phase took {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": records}))
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
