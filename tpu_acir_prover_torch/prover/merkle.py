"""Poseidon Merkle trees with caps, several levels per kernel launch.

Counterpart of ``leaf_digests``, ``merkle_levels`` and ``MerkleTree`` in
``tpu_acir_prover/prover/merkle.py``.  Levels are ``(size, 4)`` int64
tensors: ``levels[0]`` holds the leaf digests, ``levels[-1]`` the cap.
Leaves are hashed straight from the row-major ``(M, C)`` matrix.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..field import gl
from ..field.poseidon import hash_no_pad_ints, two_to_one_ints
from ..kernels import poseidon as kp


def leaf_digests(matrix: torch.Tensor) -> torch.Tensor:
    """(M, C) matrix -> (M, 4) leaf digests."""
    return kp.leaf_hash(matrix.contiguous())


def merkle_levels(leaf: torch.Tensor, cap_size: int) -> List[torch.Tensor]:
    """All digest levels from the (M, 4) leaves up to ``cap_size`` nodes;
    M and ``cap_size`` are powers of two."""
    m = leaf.shape[0]
    if m <= cap_size:
        return [leaf]
    return [leaf] + kp.two_to_one_levels(leaf, (m // cap_size).bit_length() - 1)


def gather_paths(levels: List[torch.Tensor], idx: torch.Tensor):
    """Sibling digests of the leaves at ``idx`` (a device index tensor) on
    every level below the cap: a list over levels of (q, 4) tensors."""
    out = []
    cur = idx
    for lev in levels[:-1]:
        out.append(lev.index_select(0, cur ^ 1))
        cur = cur >> 1
    return out


class MerkleTree:
    """Committed (M, C) matrix and its digest levels, on the device."""

    def __init__(self, leaves: torch.Tensor, levels: List[torch.Tensor]):
        self.leaves = leaves
        self.levels = levels

    @property
    def num_leaves(self) -> int:
        return self.leaves.shape[0]

    @property
    def cap(self) -> torch.Tensor:
        return self.levels[-1]

    def cap_u64(self) -> np.ndarray:
        """Cap digests as host uint64 (cap_size, 4)."""
        return gl.to_u64(self.cap)

    def rows_and_paths(self, indices):
        """Leaf rows (q, C) uint64 and sibling paths (per query, a list of
        uint64[4] digests from the leaf level up to below the cap), with one
        gather per level and one device->host copy per tree."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.leaves.device)
        parts = [self.leaves.index_select(0, idx)] + \
            gather_paths(self.levels, idx)
        flat = gl.to_u64(torch.cat(parts, dim=1))
        c = self.leaves.shape[1]
        nlev = len(self.levels) - 1
        rows = flat[:, :c]
        paths = [[flat[q, c + 4 * l:c + 4 * (l + 1)] for l in range(nlev)]
                 for q in range(len(indices))]
        return rows, paths


def merkle_tree(matrix: torch.Tensor, cap_height: int) -> MerkleTree:
    """Commit to an (M, C) matrix: leaf i hashes row i, levels run up to
    2^cap_height nodes (capped at the tree's height)."""
    m = matrix.shape[0]
    ch = min(cap_height, m.bit_length() - 1)
    return MerkleTree(matrix, merkle_levels(leaf_digests(matrix), 1 << ch))


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
