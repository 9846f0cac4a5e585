"""Poseidon2 Merkle trees: the verifier's path check, copied from the port's
``prover/merkle.py``, and a commitment computed with the plain torch
Poseidon2 of ``field/poseidon.py`` in blocks of rows.

Leaf i hashes row i of an (M, C) matrix (overwrite absorb in chunks of 8,
no padding); parent j of a level compresses children 2j and 2j + 1; the
cap is the level of ``2^min(cap_height, log2 M)`` digests.
"""

from __future__ import annotations

import torch

from ..field import poseidon
from ..field.poseidon import hash_no_pad_ints, two_to_one_ints

# rows hashed at a time: bounds the plain permutation's temporaries
BLOCK_ROWS = 1 << 18


def merkle_cap(matrix: torch.Tensor, cap_height: int) -> torch.Tensor:
    """The (cap, 4) cap digests of an (M, C) matrix, M a power of two."""
    m = matrix.shape[0]
    ch = min(cap_height, m.bit_length() - 1)
    level = torch.cat([poseidon.hash_no_pad(matrix[i:i + BLOCK_ROWS])
                       for i in range(0, m, BLOCK_ROWS)])
    while level.shape[0] > (1 << ch):
        half = level.shape[0] // 2
        level = torch.cat([
            poseidon.two_to_one(level[2 * i:2 * (i + BLOCK_ROWS):2],
                                level[2 * i + 1:2 * (i + BLOCK_ROWS):2])
            for i in range(0, half, BLOCK_ROWS)])
    return level


def verify_merkle_path(leaf_values_u64, index: int, path, cap_u64) -> bool:
    """Check a Merkle path against a cap (host side, scalar Poseidon).

    NB: no np.asarray on python-int inputs — numpy 2.x silently coerces
    ints >= 2^63 to float64, corrupting field elements."""
    node = hash_no_pad_ints([int(v) for v in leaf_values_u64])
    idx = index
    for sib in path:
        s = tuple(int(x) for x in sib)
        node = two_to_one_ints(s, node) if (idx & 1) else two_to_one_ints(node, s)
        idx >>= 1
    expect = tuple(int(x) for x in cap_u64[idx])
    return node == expect
