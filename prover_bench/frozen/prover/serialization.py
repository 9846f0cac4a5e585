"""Proof / verifying-key byte codecs (this framework's own stable format).

Role analog of the reference's proof/vk byte boundary
(noir_and_plonky2_serialization.rs:16-33 + BackendGateSerializer,
write_vk_action.rs:35-62).  Unlike plonky2's gate-serializer whitelist, our
vk is pure data (field parameters + preprocessed-oracle cap), so no gate
registry is needed.  Layout: little-endian fixed-width ints, u32 lengths,
u64 field elements; one magic+version word each.
"""

from __future__ import annotations

import struct
from typing import List

from .compress import CompressedProof
from .proof import (FriStep, Openings, OracleOpening, Proof, QueryRound,
                    VerifyingKey)

VK_MAGIC = 0x54505532  # "TPU2"
PROOF_MAGIC = 0x54505033  # "TPP3"
COMPRESSED_PROOF_MAGIC = 0x54505043  # "TPPC"
VERSION = 2  # v2: wide gate (16 wires), partial products, LogUp lookups


class _W:
    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", v))

    def ext(self, e):
        self.u64(e[0])
        self.u64(e[1])

    def digest(self, d):
        for x in d:
            self.u64(x)

    def cap(self, cap):
        self.u32(len(cap))
        for d in cap:
            self.digest(d)

    def ext_list(self, xs):
        self.u32(len(xs))
        for e in xs:
            self.ext(e)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, data: bytes):
        self.b = data
        self.o = 0

    def _take(self, n):
        if self.o + n > len(self.b):
            raise ValueError("truncated proof/vk data")
        out = self.b[self.o:self.o + n]
        self.o += n
        return out

    def u8(self):
        return struct.unpack("<B", self._take(1))[0]

    def u32(self):
        return struct.unpack("<I", self._take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self._take(8))[0]

    def ext(self):
        return (self.u64(), self.u64())

    def digest(self):
        return tuple(self.u64() for _ in range(4))

    def cap(self):
        return [self.digest() for _ in range(self.u32())]

    def ext_list(self):
        return [self.ext() for _ in range(self.u32())]

    def done(self):
        return self.o == len(self.b)


def serialize_vk(vk: VerifyingKey) -> bytes:
    w = _W()
    w.u32(VK_MAGIC)
    w.u32(VERSION)
    for v in (vk.log_n, vk.num_wires, vk.num_public_inputs,
              vk.num_quotient_chunks, vk.rate_bits, vk.cap_height,
              vk.num_queries, vk.pow_bits, vk.final_poly_domain,
              vk.lookup_bits):
        w.u32(v)
    w.u32(len(vk.k_shifts))
    for k in vk.k_shifts:
        w.u64(k)
    w.cap(vk.constants_cap)
    return w.bytes()


def deserialize_vk(data: bytes) -> VerifyingKey:
    r = _R(data)
    if r.u32() != VK_MAGIC or r.u32() != VERSION:
        raise ValueError("not a tpu_acir_prover verifying key")
    (log_n, num_wires, num_pub, nch, rate_bits, cap_height, num_queries,
     pow_bits, final_domain, lookup_bits) = (r.u32() for _ in range(10))
    k_shifts = tuple(r.u64() for _ in range(r.u32()))
    cap = r.cap()
    if not r.done():
        raise ValueError("trailing bytes in verifying key")
    return VerifyingKey(
        log_n=log_n, num_wires=num_wires, num_public_inputs=num_pub,
        k_shifts=k_shifts, num_quotient_chunks=nch, rate_bits=rate_bits,
        cap_height=cap_height, num_queries=num_queries, pow_bits=pow_bits,
        final_poly_domain=final_domain, lookup_bits=lookup_bits,
        constants_cap=cap)


def _write_opening(w: _W, o: OracleOpening):
    w.u32(len(o.row))
    for v in o.row:
        w.u64(v)
    w.u32(len(o.path))
    for d in o.path:
        w.digest(d)


def _read_opening(r: _R) -> OracleOpening:
    row = [r.u64() for _ in range(r.u32())]
    path = [r.digest() for _ in range(r.u32())]
    return OracleOpening(row=row, path=path)


def serialize_proof(p: Proof) -> bytes:
    w = _W()
    w.u32(PROOF_MAGIC)
    w.u32(VERSION)
    w.u32(len(p.public_inputs))
    for v in p.public_inputs:
        w.u64(v)
    w.cap(p.wires_cap)
    w.cap(p.z_cap)
    w.cap(p.quotient_cap)
    op = p.openings
    for group in (op.constants_sigmas, op.wires, op.z, op.z_next, op.quotient):
        w.ext_list(group)
    w.u32(len(p.fri_caps))
    for c in p.fri_caps:
        w.cap(c)
    w.ext_list(p.fri_final_coeffs)
    w.u64(p.fri_pow_witness)
    w.u32(len(p.fri_queries))
    for q in p.fri_queries:
        w.u32(len(q.initial))
        for o in q.initial:
            _write_opening(w, o)
        w.u32(len(q.steps))
        for s in q.steps:
            w.ext(s.pair[0])
            w.ext(s.pair[1])
            w.u32(len(s.path))
            for d in s.path:
                w.digest(d)
    return w.bytes()


def serialize_compressed_proof(p: CompressedProof) -> bytes:
    """Compressed wire format (the reference always writes compressed
    proofs, prove_action.rs:64-79); shares every section with
    serialize_proof except query rounds, which carry rows/pairs only plus
    the per-tree pruned sibling streams."""
    w = _W()
    w.u32(COMPRESSED_PROOF_MAGIC)
    w.u32(VERSION)
    w.u32(len(p.public_inputs))
    for v in p.public_inputs:
        w.u64(v)
    w.cap(p.wires_cap)
    w.cap(p.z_cap)
    w.cap(p.quotient_cap)
    op = p.openings
    for group in (op.constants_sigmas, op.wires, op.z, op.z_next, op.quotient):
        w.ext_list(group)
    w.u32(len(p.fri_caps))
    for c in p.fri_caps:
        w.cap(c)
    w.ext_list(p.fri_final_coeffs)
    w.u64(p.fri_pow_witness)
    w.u32(len(p.query_rows))
    for rows, pairs in zip(p.query_rows, p.step_pairs):
        w.u32(len(rows))
        for row in rows:
            w.u32(len(row))
            for v in row:
                w.u64(v)
        w.u32(len(pairs))
        for (v0, v1) in pairs:
            w.ext(v0)
            w.ext(v1)
    w.u32(len(p.pruned_paths))
    for stream in p.pruned_paths:
        w.u32(len(stream))
        for d in stream:
            w.digest(d)
    return w.bytes()


def deserialize_compressed_proof(data: bytes) -> CompressedProof:
    r = _R(data)
    if r.u32() != COMPRESSED_PROOF_MAGIC or r.u32() != VERSION:
        raise ValueError("not a tpu_acir_prover compressed proof")
    public_inputs = [r.u64() for _ in range(r.u32())]
    wires_cap = r.cap()
    z_cap = r.cap()
    quotient_cap = r.cap()
    groups = [r.ext_list() for _ in range(5)]
    openings = Openings(*groups)
    fri_caps = [r.cap() for _ in range(r.u32())]
    final_coeffs = r.ext_list()
    pow_witness = r.u64()
    query_rows = []
    step_pairs = []
    for _ in range(r.u32()):
        query_rows.append([[r.u64() for _ in range(r.u32())]
                           for _ in range(r.u32())])
        step_pairs.append([(r.ext(), r.ext()) for _ in range(r.u32())])
    pruned = [[r.digest() for _ in range(r.u32())] for _ in range(r.u32())]
    if not r.done():
        raise ValueError("trailing bytes in compressed proof")
    return CompressedProof(
        public_inputs=public_inputs, wires_cap=wires_cap, z_cap=z_cap,
        quotient_cap=quotient_cap, openings=openings, fri_caps=fri_caps,
        fri_final_coeffs=final_coeffs, fri_pow_witness=pow_witness,
        query_rows=query_rows, step_pairs=step_pairs, pruned_paths=pruned)


def deserialize_proof(data: bytes) -> Proof:
    r = _R(data)
    if r.u32() != PROOF_MAGIC or r.u32() != VERSION:
        raise ValueError("not a tpu_acir_prover proof")
    public_inputs = [r.u64() for _ in range(r.u32())]
    wires_cap = r.cap()
    z_cap = r.cap()
    quotient_cap = r.cap()
    groups = [r.ext_list() for _ in range(5)]
    openings = Openings(*groups)
    fri_caps = [r.cap() for _ in range(r.u32())]
    final_coeffs = r.ext_list()
    pow_witness = r.u64()
    queries = []
    for _ in range(r.u32()):
        initial = [_read_opening(r) for _ in range(r.u32())]
        steps = []
        for _ in range(r.u32()):
            pair = (r.ext(), r.ext())
            path = [r.digest() for _ in range(r.u32())]
            steps.append(FriStep(pair=pair, path=path))
        queries.append(QueryRound(initial=initial, steps=steps))
    if not r.done():
        raise ValueError("trailing bytes in proof")
    return Proof(public_inputs=public_inputs, wires_cap=wires_cap,
                 z_cap=z_cap, quotient_cap=quotient_cap, openings=openings,
                 fri_caps=fri_caps, fri_final_coeffs=final_coeffs,
                 fri_pow_witness=pow_witness, fri_queries=queries)
