"""Proof-system configuration.

Defaults chosen for ~100-bit conjectured soundness, the same budget class as
the reference's plonky2 standard config (rate 1/8, 28 queries, 16 PoW bits;
reference constants live in the external fork, SURVEY.md §2.3).  The
reference itself exposes no config surface (SURVEY.md §5 "Config"); we make
it explicit so tests can shrink FRI work.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProofConfig:
    rate_bits: int = 3          # LDE blowup 2^3 = 8
    cap_height: int = 4         # Merkle cap 2^4 digests
    num_queries: int = 28       # FRI query repetitions
    pow_bits: int = 16          # proof-of-work grinding bits
    final_poly_domain: int = 256  # stop folding at this domain size

    @property
    def rate(self) -> int:
        return 1 << self.rate_bits


# plonky2-standard-class default
STANDARD_CONFIG = ProofConfig()

# cheap config for unit tests (soundness irrelevant there)
TEST_CONFIG = ProofConfig(rate_bits=3, cap_height=1, num_queries=8,
                          pow_bits=4, final_poly_domain=64)
