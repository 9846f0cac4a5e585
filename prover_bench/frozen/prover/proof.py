"""Proof / verifying-key containers.

In-memory form uses python ints (field elements) and tuples; byte codecs
live in serialization.py.  Functional analog of the reference's
CompressedProofWithPublicInputs + VerifierCircuitData
(noir_and_plonky2_serialization.rs:16-33), with our own layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

Digest = Tuple[int, int, int, int]
Ext = Tuple[int, int]


@dataclass
class OracleOpening:
    """One oracle's data at one query index: leaf row + Merkle path."""
    row: List[int]              # base field values (all columns at the index)
    path: List[Digest]


@dataclass
class FriStep:
    """One committed FRI layer at one query: the (v_lo, v_hi) pair leaf."""
    pair: Tuple[Ext, Ext]
    path: List[Digest]


@dataclass
class QueryRound:
    initial: List[OracleOpening]   # [constants_sigmas, wires, z, quotient]
    steps: List[FriStep]


@dataclass
class Openings:
    constants_sigmas: List[Ext]    # NUM_SELECTORS + W (+1 table)
    wires: List[Ext]               # W (+1 multiplicity)
    z: List[Ext]                   # 2 per round-2 ext column (Z, partials,
                                   # lookup helpers, h_T, S)
    z_next: List[Ext]              # same columns, opened at g*zeta
    quotient: List[Ext]            # 2 * num_chunks

    def ordered(self) -> List[Ext]:
        return (list(self.constants_sigmas) + list(self.wires) +
                list(self.z) + list(self.z_next) + list(self.quotient))


@dataclass
class Proof:
    public_inputs: List[int]
    wires_cap: List[Digest]
    z_cap: List[Digest]
    quotient_cap: List[Digest]
    openings: Openings
    fri_caps: List[List[Digest]]   # committed fold layers, L0 first
    fri_final_coeffs: List[Ext]
    fri_pow_witness: int
    fri_queries: List[QueryRound]


@dataclass
class VerifyingKey:
    log_n: int
    num_wires: int
    num_public_inputs: int
    k_shifts: Tuple[int, ...]
    num_quotient_chunks: int
    rate_bits: int
    cap_height: int
    num_queries: int
    pow_bits: int
    final_poly_domain: int
    lookup_bits: int = 0           # 0 = circuit carries no lookup argument
    constants_cap: List[Digest] = field(default_factory=list)
