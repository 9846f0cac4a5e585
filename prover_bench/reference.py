"""The plain reference that decides ``correct``.

It reads the same files the program read (the ACIR artifact, each proof's
witness file) and the files the program wrote (the verifying key, each
compressed proof), and imports nothing of the program: its code is the
frozen copy in ``frozen/`` and plain torch.

- ``derive_vk`` works the verifying key out again from the artifact:
  translate, the preprocessed columns (``frozen/circuit/shape.py``), their
  coset LDE and Merkle cap by plain torch ops (on the card in a run).
- ``wires_cap`` works a proof's wire commitment out again from its witness
  file: every variable solved from the file's values by the circuit's
  generators, one at a time in python ints (``solve``), the wire matrix
  routed from them, its LDE and Merkle cap as above.  It holds the
  program's witness fill, and each proof, to the witness it was given.
- ``judge_proof`` decompresses a proof file under that key and runs the
  frozen verifier: the Fiat-Shamir transcript over every commitment, the
  gate, permutation and lookup identity at zeta against the openings,
  every FRI query's Merkle paths and folds, the final polynomial's degree
  and the grind's nonce.  A proof made from a witness that breaks any
  constraint, or under weaker parameters, fails here.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import subprocess
import sys
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .frozen.acir import codec
from .frozen.acir.translator import translate_program
from .frozen.circuit import builder as B
from .frozen.circuit.shape import CircuitShape, circuit_shape
from .frozen.field import gl, poseidon
from .frozen.field.gl import P
from .frozen.prover.compress import decompress_proof
from .frozen.prover.config import ProofConfig
from .frozen.prover.merkle import merkle_cap
from .frozen.prover.ntt import coset_lde, intt
from .frozen.prover.proof import VerifyingKey
from .frozen.prover.serialization import (COMPRESSED_PROOF_MAGIC,
                                          deserialize_compressed_proof,
                                          serialize_vk)
from .frozen.prover.verify import verify
from .roofline import NUM_CHUNKS

# columns put through one NTT: bounds the plain NTT's temporaries
NTT_COLS = 16


def proof_config(cfg: dict) -> ProofConfig:
    return ProofConfig(**cfg["proof_config"])


class Circuit(NamedTuple):
    translation: object          # frozen AcirTranslator: builder, witness ids
    shape: CircuitShape


def load_circuit(artifact_path: str) -> Circuit:
    tr = translate_program(codec.load_program_artifact(artifact_path))
    return Circuit(tr, circuit_shape(tr.builder))


def _cap(columns: np.ndarray, config: ProofConfig, device) -> List[tuple]:
    """Merkle cap of the coset LDE of (C, n) uint64 columns."""
    values = gl.from_u64(np.ascontiguousarray(columns.T), device)
    lde = torch.cat([coset_lde(intt(values[:, i:i + NTT_COLS]),
                               config.rate_bits)
                     for i in range(0, values.shape[1], NTT_COLS)], dim=1)
    del values
    cap = gl.to_u64(merkle_cap(lde, config.cap_height))
    return [tuple(int(x) for x in d) for d in cap]


def derive_vk(circuit: Circuit, config: ProofConfig, device) -> VerifyingKey:
    shape = circuit.shape
    cols = [shape.selectors, shape.sigma]
    if shape.lookup_bits:
        cols.append(shape.table.reshape(1, shape.n))
    m = shape.n << config.rate_bits
    return VerifyingKey(
        log_n=shape.log_n, num_wires=len(shape.k_shifts),
        num_public_inputs=shape.num_public_inputs, k_shifts=shape.k_shifts,
        num_quotient_chunks=NUM_CHUNKS, rate_bits=config.rate_bits,
        cap_height=config.cap_height, num_queries=config.num_queries,
        pow_bits=config.pow_bits,
        final_poly_domain=min(config.final_poly_domain, m),
        lookup_bits=shape.lookup_bits,
        constants_cap=_cap(np.concatenate(cols, axis=0), config, device))


_TWO_INPUTS = (B.GEN_ADD, B.GEN_SUB, B.GEN_MUL, B.GEN_MULADDC, B.GEN_MULMULC)


def solve(circuit: Circuit, witness_map: dict) -> List[int]:
    """Every variable's value: the ACIR witnesses from the map, then each
    generator of the builder in creation order, in python ints, an op whose
    inputs are not yet known put off to a later pass."""
    tr = circuit.translation
    b = tr.builder
    vals: List[Optional[int]] = [None] * b.num_vars
    for w, v in tr.witness_to_var.items():
        vals[v] = witness_map.get(w, 0) % P
    hints = {}
    todo = [op for op in b.gen_ops if op.op != B.GEN_EXTERNAL]
    while todo:
        later = []
        for op in todo:
            k = op.op
            if k == B.GEN_CONST:
                vals[op.out] = op.const % P
                continue
            if k == B.GEN_HINT_OUT:
                if op.a not in hints:
                    ins = [vals[i] for i in b.hints[op.a].inputs]
                    if None in ins:
                        later.append(op)
                        continue
                    hints[op.a] = [x % P for x in b.hints[op.a].fn(ins)]
                vals[op.out] = hints[op.a][op.const]
                continue
            x = vals[op.a]
            y = vals[op.b] if k in _TWO_INPUTS else 0
            if x is None or y is None:
                later.append(op)
                continue
            if k == B.GEN_ADD:
                r = (x + y) % P
            elif k == B.GEN_SUB:
                r = (x - y) % P
            elif k == B.GEN_MUL:
                r = x * y % P
            elif k == B.GEN_MULADDC:
                r = (x * op.const + y) % P
            elif k == B.GEN_MULMULC:
                r = x * y % P * op.const % P
            elif k == B.GEN_INV:
                r = pow(x, P - 2, P)            # 0 -> 0
            elif k == B.GEN_BIT:
                r = (x >> op.const) & 1
            else:
                raise ValueError(f"generator opcode {k}")
            vals[op.out] = r
        if len(later) == len(todo):
            raise ValueError(f"{len(todo)} generators never get their inputs")
        todo = later
    return [0 if v is None else v for v in vals]


def wire_columns(circuit: Circuit, vals: List[int]) -> np.ndarray:
    """(W, n) uint64 wire matrix, with the lookup multiplicity column (how
    many looked-up slots hold each table value) as a last row where the
    circuit has lookups: the columns of the proof's first commitment."""
    shape = circuit.shape
    wires = np.array(vals, dtype=np.uint64)[shape.wire_vars]
    if not shape.lookup_bits:
        return wires
    looked = wires[:, shape.lookup_rows].reshape(-1).astype(np.int64)
    m = np.bincount(looked, minlength=shape.n)[:shape.n].astype(np.uint64)
    return np.concatenate([wires, m.reshape(1, shape.n)])


def wires_cap(circuit: Circuit, witness_path: str, config: ProofConfig,
              device) -> List[tuple]:
    """The cap of the wire commitment that a proof of this witness file
    makes."""
    vals = solve(circuit, witness_map(witness_path))
    return _cap(wire_columns(circuit, vals), config, device)


def vk_bytes(vk: VerifyingKey) -> bytes:
    return serialize_vk(vk)


@contextmanager
def _remembered_permutations():
    """The decompressor rebuilds each query's Merkle path and the verifier
    checks it again: the same permutations, computed once here."""
    plain = poseidon.permute_ints
    seen = {}

    def permute(state):
        key = tuple(state)
        if key not in seen:
            seen[key] = plain(state)
        return list(seen[key])

    poseidon.permute_ints = permute
    try:
        yield
    finally:
        poseidon.permute_ints = plain


def judge_proof(vk: VerifyingKey, data: bytes) -> str:
    """'' when the compressed proof ``data`` verifies under ``vk``, else
    why not."""
    if len(data) < 4 or struct.unpack("<I", data[:4])[0] != \
            COMPRESSED_PROOF_MAGIC:
        return "not a compressed proof"
    try:
        with _remembered_permutations():
            verify(vk, decompress_proof(vk,
                                        deserialize_compressed_proof(data)))
    except Exception as e:  # any failure to verify is a rejection
        return f"{type(e).__name__}: {e}"[:200]
    return ""


def _judge_file(vk: VerifyingKey, path: str) -> str:
    with open(path, "rb") as f:
        return judge_proof(vk, f.read())


def judge_files(vk: VerifyingKey, paths: List[str],
                meanwhile: Callable[[], object] = lambda: None
                ) -> Tuple[List[str], object]:
    """``judge_proof`` of each file, the files dealt round to worker
    processes (at most one a core but one), each a plain child of this
    process (``python -m prover_bench.reference``) that sees no card and
    is waited for, or killed and waited for, before this returns;
    ``meanwhile()`` runs in this process as they work.  A worker that ends
    without its verdicts rejects its files.  Returns the verdicts and what
    ``meanwhile`` returned."""
    workers = max(1, min(len(paths), (os.cpu_count() or 2) - 1))
    if workers == 1:
        return [_judge_file(vk, p) for p in paths], meanwhile()
    groups = [paths[i::workers] for i in range(workers)]
    root = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs: List[subprocess.Popen] = []
    with tempfile.TemporaryDirectory(prefix="prover_bench_vk_") as tmp:
        vk_file = os.path.join(tmp, "vk.pkl")
        with open(vk_file, "wb") as f:
            pickle.dump(vk, f)
        try:
            for group in groups:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "prover_bench.reference", vk_file,
                     *group], stdout=subprocess.PIPE, cwd=root, env=env))
            other = meanwhile()
            said = [proc.communicate()[0] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    out: List[str] = []
    for i in range(len(paths)):
        proc, got = procs[i % workers], said[i % workers]
        try:
            out.append(json.loads(got.splitlines()[-1])[i // workers])
        except (ValueError, IndexError, TypeError):
            out.append(f"judge worker exited {proc.returncode} "
                       f"without a verdict")
    return out, other


def proof_wires_cap(data: bytes):
    """The wire commitment's cap of a compressed proof, as a list of
    digests, or None where the bytes do not parse."""
    try:
        return [tuple(d) for d in deserialize_compressed_proof(data).wires_cap]
    except Exception:  # a proof that does not parse is judge_proof's
        return None


def witness_map(path: str) -> dict:
    ws = codec.load_witness_stack(path)
    return ws.peek().witness if ws.stack else {}


def _judge_main(argv: List[str]) -> int:
    """A worker of ``judge_files``: the verdicts of the proof files
    ``argv[1:]`` under the pickled key ``argv[0]``, as a JSON list on
    standard output."""
    with open(argv[0], "rb") as f:
        vk = pickle.load(f)
    print(json.dumps([_judge_file(vk, p) for p in argv[1:]]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_judge_main(sys.argv[1:]))
