"""The card's peaks and the Poseidon2 hashing a proof must do.

Peaks of one NVIDIA H100 SXM (80 GB HBM3) at its full 700 W: device memory
3.35 TB/s (NVIDIA's H100 data sheet); 32-bit integer multiply-adds 132 SMs
x 64 a clock (the CUDA C++ Programming Guide's table of arithmetic
instruction throughput, compute capability 9.0) at the 1.98 GHz boost
clock.  A Poseidon2 permutation of width 12 is 736 Goldilocks products of
8 multiply-adds each.  These are the bound arithmetic of the port's
``kernels/bench.py`` and ``kernels/field_bench.py``, copied.

``merkle_work`` counts, from a verifying key's widths and proof parameters
alone, the leaves and tree levels that every proof commits to: the wires
(and the lookup's multiplicities), the permutation and lookup columns, the
quotient chunks, and each FRI layer; not the preprocessed commitment, which
the proving key holds.  So the count reads the same work whatever
implements it.
"""

from __future__ import annotations

from typing import List, NamedTuple

from .frozen.circuit.builder import lookup_groups, perm_groups

BYTES_PER_S = 3.35e12
MADDS_PER_S = 132 * 64 * 1.98e9
MADDS_PER_PERMUTATION = 736 * 8
RATE = 8          # field elements a permutation absorbs
DIGEST_BYTES = 32
# quotient chunks of every proof, two base columns each (the port's
# prover/prove.py NUM_CHUNKS: constraint degree <= 7 at rate 8)
NUM_CHUNKS = 6


class Hashing(NamedTuple):
    """One launch's worth of Poseidon2 work: ``kind`` is "leaves" (``rows``
    rows of ``cols`` elements hashed to digests) or "tree" (``rows`` leaf
    digests compressed level by level up to ``cap`` digests)."""
    kind: str
    rows: int
    cols: int
    cap: int

    @property
    def permutations(self) -> int:
        if self.kind == "leaves":
            return self.rows * -(-self.cols // RATE)
        return self.rows - self.cap

    @property
    def bytes(self) -> int:
        if self.kind == "leaves":
            return self.rows * (self.cols * 8 + DIGEST_BYTES)
        return (2 * self.rows - self.cap) * DIGEST_BYTES

    def least_s(self) -> float:
        """The larger of the bytes' and the multiply-adds' times."""
        return max(self.bytes / BYTES_PER_S,
                   self.permutations * MADDS_PER_PERMUTATION / MADDS_PER_S)


def _commit(rows: int, cols: int, cap_height: int) -> List[Hashing]:
    cap = 1 << min(cap_height, rows.bit_length() - 1)
    return [Hashing("leaves", rows, cols, cap), Hashing("tree", rows, cols, cap)]


def merkle_work(vk) -> List[Hashing]:
    """The hashing of one proof under verifying key ``vk``."""
    m = 1 << (vk.log_n + vk.rate_bits)
    w = vk.num_wires
    lookups = vk.lookup_bits > 0
    num_z_ext = len(perm_groups(w)) + \
        (len(lookup_groups(w)) + 2 if lookups else 0)
    work = []
    for cols in (w + lookups, 2 * num_z_ext, 2 * NUM_CHUNKS):
        work += _commit(m, cols, vk.cap_height)
    size = m
    while size > vk.final_poly_domain:
        # a FRI layer's leaf packs (F(x), F(-x)) as 4 base elements
        work += _commit(size // 2, 4, vk.cap_height)
        size //= 2
    return work


def least_s(work: List[Hashing]) -> float:
    return sum(h.least_s() for h in work)
