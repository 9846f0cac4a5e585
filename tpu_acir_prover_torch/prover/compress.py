"""Compressed proofs: Merkle-path pruning across FRI query rounds.

Functional analog of the reference's proof compression step — plonky2's
`proof.compress(circuit_digest, common)` called at prove_action.rs:75-78 and
consumed by `verify_compressed` (verify_action.rs:14-16) /
`CompressedProofWithPublicInputs::from_bytes`
(noir_and_plonky2_serialization.rs:24-33).  Like plonky2, we drop every
Merkle sibling digest the verifier can recompute:

  * leaf digests of queried indices are computable from the leaf rows
    already present in the proof, so siblings whose whole subtree is
    queried are pruned;
  * a sibling referenced by several query rounds is stored once;
  * every internal node on an already-walked query path is known to the
    verifier, so later rounds referencing it as a sibling carry nothing.

Prover-side pruning and verifier-side reconstruction walk the query rounds
in the same deterministic order (queries in proof order, tree levels bottom
up, oracles before FRI layers), so the flat pruned-digest stream needs no
per-entry addressing.  The prover hands the compressor the query indices
it drew (``api.prove_file``), which it holds to the proof's shape; a caller
that holds only the proof has them re-derived from the Fiat-Shamir
transcript (verify.derive_transcript), mirroring how the reference needs
`CommonCircuitData` to (de)compress.  The decompressor always re-derives
them: the verifier trusts no index the proof brings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from ..field.poseidon import hash_no_pad_ints, two_to_one_ints
from ..utils.timing import PhaseTimer
from .proof import (Digest, Ext, FriStep, Openings, OracleOpening, Proof,
                    QueryRound, VerifyingKey)


@dataclass
class CompressedProof:
    """A Proof minus all reconstructible Merkle path digests."""
    public_inputs: List[int]
    wires_cap: List[Digest]
    z_cap: List[Digest]
    quotient_cap: List[Digest]
    openings: Openings
    fri_caps: List[List[Digest]]
    fri_final_coeffs: List[Ext]
    fri_pow_witness: int
    query_rows: List[List[List[int]]]        # [query][oracle] -> leaf row u64s
    step_pairs: List[List[Tuple[Ext, Ext]]]  # [query][layer] -> (v0, v1)
    pruned_paths: List[List[Digest]]         # per tree: surviving siblings


def _closure(leaf_indices, path_len: int) -> List[Set[int]]:
    """Per-level sets of nodes computable from the queried leaves alone."""
    levels = [set(leaf_indices)]
    for _ in range(path_len):
        prev = levels[-1]
        levels.append({i >> 1 for i in prev if (i ^ 1) in prev})
    return levels


class _TreePruner:
    """Prover side: decides, in verifier order, which siblings survive."""

    def __init__(self, leaf_indices, path_len: int):
        self.levels = _closure(leaf_indices, path_len)
        self.avail: Set[Tuple[int, int]] = set()
        for l, nodes in enumerate(self.levels):
            self.avail.update((l, i) for i in nodes)
        self.out: List[Digest] = []

    def walk(self, index: int, path: List[Digest]) -> None:
        cur = index
        for l, sib in enumerate(path):
            s = cur ^ 1
            if (l, s) not in self.avail:
                self.out.append(tuple(int(x) for x in sib))
                self.avail.add((l, s))
            self.avail.add((l + 1, cur >> 1))
            cur >>= 1


class _TreeRebuilder:
    """Verifier side: replays the same walk, computing node digests."""

    def __init__(self, rows_by_index: Dict[int, List[int]], path_len: int,
                 pruned: List[Digest]):
        self.vals: Dict[Tuple[int, int], Digest] = {}
        for i, row in rows_by_index.items():
            self.vals[(0, i)] = hash_no_pad_ints([int(v) for v in row])
        levels = _closure(rows_by_index.keys(), path_len)
        for l in range(path_len):
            for i in levels[l + 1]:
                self.vals[(l + 1, i)] = two_to_one_ints(
                    self.vals[(l, 2 * i)], self.vals[(l, 2 * i + 1)])
        self.path_len = path_len
        self.stream = pruned
        self.pos = 0

    def walk(self, index: int) -> List[Digest]:
        path = []
        cur = index
        node = self.vals[(0, index)]
        for l in range(self.path_len):
            s = cur ^ 1
            sib = self.vals.get((l, s))
            if sib is None:
                if self.pos >= len(self.stream):
                    raise ValueError("compressed proof: pruned-path underrun")
                sib = self.stream[self.pos]
                self.pos += 1
                self.vals[(l, s)] = sib
            path.append(sib)
            parent = (two_to_one_ints(sib, node) if (cur & 1)
                      else two_to_one_ints(node, sib))
            cur >>= 1
            self.vals[(l + 1, cur)] = parent
            node = parent
        return path

    def done(self) -> bool:
        return self.pos == len(self.stream)


def _fri_layer_indices(indices, num_layers: int, m: int):
    """Per-layer leaf indices for each query (idx % h, h halving)."""
    per_layer = []
    cur = list(indices)
    size = m
    for _ in range(num_layers):
        h = size // 2
        cur = [i % h for i in cur]
        per_layer.append(list(cur))
        size = h
    return per_layer


def compress_proof(vk: VerifyingKey, proof: Proof, timer: PhaseTimer = None,
                   indices=None) -> CompressedProof:
    """The proof with its reconstructible Merkle digests pruned.

    ``indices``: the query indices the prover drew for this proof (the
    provers' ``with_indices``), checked against the proof's shape; without
    them the transcript is replayed for them, which an enabled ``timer``
    counts in ``compress_replays``.  A malformed proof raises
    ``VerificationError`` either way."""
    from .verify import derive_transcript
    timer = timer or PhaseTimer(enabled=False)
    with timer.phase("compress_transcript"):
        replayed = indices is None
        if replayed:
            indices = derive_transcript(vk, proof)[-1]
        else:
            _check_shape(vk, proof, indices)
        timer.count("compress_replays", int(replayed))
    with timer.phase("compress_prune"):
        return _prune(vk, proof, indices)


def _check_shape(vk: VerifyingKey, proof: Proof, indices) -> None:
    """What ``derive_transcript`` checks of a proof's shape on its way to
    the indices, and that the indices fit the proof."""
    from .verify import VerificationError
    m = (1 << vk.log_n) << vk.rate_bits
    if not len(indices) == vk.num_queries == len(proof.fri_queries):
        raise VerificationError("query count mismatch")
    if not all(0 <= i < m for i in indices):
        raise VerificationError("query index out of range")
    num_layers, cur = 0, m
    while cur > vk.final_poly_domain:
        num_layers += 1
        cur //= 2
    if len(proof.fri_caps) < num_layers:
        raise VerificationError("missing FRI layer caps")
    if len(proof.fri_caps) > num_layers:
        raise VerificationError("extra FRI layer caps")
    if len(proof.fri_final_coeffs) != vk.final_poly_domain:
        raise VerificationError("final poly length mismatch")


def _prune(vk: VerifyingKey, proof: Proof, indices) -> CompressedProof:
    m = (1 << vk.log_n) << vk.rate_bits
    num_layers = len(proof.fri_caps)
    layer_idx = _fri_layer_indices(indices, num_layers, m)

    pruned: List[List[Digest]] = []
    # oracle trees (constants, wires, z, quotient) share the leaf index set
    for oi in range(4):
        path_len = len(proof.fri_queries[0].initial[oi].path)
        pr = _TreePruner(indices, path_len)
        for q, round_ in zip(indices, proof.fri_queries):
            pr.walk(q, round_.initial[oi].path)
        pruned.append(pr.out)
    for li in range(num_layers):
        path_len = len(proof.fri_queries[0].steps[li].path)
        pr = _TreePruner(layer_idx[li], path_len)
        for qi, round_ in enumerate(proof.fri_queries):
            pr.walk(layer_idx[li][qi], round_.steps[li].path)
        pruned.append(pr.out)

    return CompressedProof(
        public_inputs=proof.public_inputs,
        wires_cap=proof.wires_cap, z_cap=proof.z_cap,
        quotient_cap=proof.quotient_cap, openings=proof.openings,
        fri_caps=proof.fri_caps, fri_final_coeffs=proof.fri_final_coeffs,
        fri_pow_witness=proof.fri_pow_witness,
        query_rows=[[list(o.row) for o in r.initial]
                    for r in proof.fri_queries],
        step_pairs=[[s.pair for s in r.steps] for r in proof.fri_queries],
        pruned_paths=pruned)


def decompress_proof(vk: VerifyingKey, cp: CompressedProof) -> Proof:
    """Rebuild the full per-query Merkle paths; the result feeds the
    standard verifier unchanged (verify.verify)."""
    from .verify import derive_transcript, VerificationError
    # transcript only touches commitments/openings, which CompressedProof
    # shares with Proof — a shape-only dummy for the query rounds suffices
    skeleton = Proof(
        public_inputs=cp.public_inputs, wires_cap=cp.wires_cap,
        z_cap=cp.z_cap, quotient_cap=cp.quotient_cap, openings=cp.openings,
        fri_caps=cp.fri_caps, fri_final_coeffs=cp.fri_final_coeffs,
        fri_pow_witness=cp.fri_pow_witness, fri_queries=[])
    m = (1 << vk.log_n) << vk.rate_bits
    indices = derive_transcript(vk, skeleton)[-1]
    nq = vk.num_queries
    if len(cp.query_rows) != nq or len(cp.step_pairs) != nq:
        raise VerificationError("compressed proof: query count mismatch")
    num_layers = len(cp.fri_caps)
    layer_idx = _fri_layer_indices(indices, num_layers, m)
    log_m = m.bit_length() - 1
    cap_h = vk.cap_height

    if len(cp.pruned_paths) != 4 + num_layers:
        raise VerificationError("compressed proof: tree count mismatch")

    rebuilders = []
    for oi in range(4):
        rows = {}
        for q, per_oracle in zip(indices, cp.query_rows):
            if len(per_oracle) != 4:
                raise VerificationError("compressed proof: oracle count")
            prev = rows.get(q)
            if prev is not None and list(prev) != list(per_oracle[oi]):
                raise VerificationError(
                    "compressed proof: conflicting rows for one index")
            rows[q] = per_oracle[oi]
        rebuilders.append(_TreeRebuilder(rows, log_m - cap_h,
                                         cp.pruned_paths[oi]))
    for li in range(num_layers):
        rows = {}
        for qi in range(nq):
            if len(cp.step_pairs[qi]) != num_layers:
                raise VerificationError("compressed proof: layer count")
            (v0, v1) = cp.step_pairs[qi][li]
            row = [v0[0], v0[1], v1[0], v1[1]]
            j = layer_idx[li][qi]
            prev = rows.get(j)
            if prev is not None and prev != row:
                raise VerificationError(
                    "compressed proof: conflicting FRI pairs for one index")
            rows[j] = row
        layer_log = log_m - (li + 1)
        layer_cap_h = min(cap_h, layer_log)
        rebuilders.append(_TreeRebuilder(rows, layer_log - layer_cap_h,
                                         cp.pruned_paths[4 + li]))

    queries = []
    for qi in range(nq):
        initial = [OracleOpening(row=list(cp.query_rows[qi][oi]),
                                 path=rebuilders[oi].walk(indices[qi]))
                   for oi in range(4)]
        steps = [FriStep(pair=cp.step_pairs[qi][li],
                         path=rebuilders[4 + li].walk(layer_idx[li][qi]))
                 for li in range(num_layers)]
        queries.append(QueryRound(initial=initial, steps=steps))
    for rb in rebuilders:
        if not rb.done():
            raise VerificationError("compressed proof: trailing pruned digests")

    return Proof(
        public_inputs=cp.public_inputs, wires_cap=cp.wires_cap,
        z_cap=cp.z_cap, quotient_cap=cp.quotient_cap, openings=cp.openings,
        fri_caps=cp.fri_caps, fri_final_coeffs=cp.fri_final_coeffs,
        fri_pow_witness=cp.fri_pow_witness, fri_queries=queries)
