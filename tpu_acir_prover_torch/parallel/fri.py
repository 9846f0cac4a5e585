"""Sharded FRI: layer commit and fold over the sp (domain) mesh axis.

Counterpart of ``tpu_acir_prover/parallel/fri.py``.  The single-device FRI
(``prover/prove.py``: ``fri_commit_layer``, ``fri_fold_body``) keeps each
layer as a GF(p^2) value vector on the coset in natural order; leaf j of a
layer tree packs the fold pair (F(x_j), F(-x_j)), rows j and j+h.  With the
domain sharded as contiguous row blocks over d shards, a fold step is two
ppermutes:

  1. pair exchange: shard s >= d/2 ships its block to s - d/2, so each low
     shard holds both halves of its pairs (the +/- coset points);
  2. rebalance: each low shard splits its folded block in two and ships the
     halves to shards 2s and 2s+1, restoring even natural-order sharding
     for the next layer.

Leaf hashing and the Merkle subtree stay local, on the low shards (the
high shards' halves of a layer are all in their partners' leaves); each
low shard contributes cap_total/(d/2) cap digests, gathered in order.
Caps and folded values are bit-identical to the single-device path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.compile import powers_u64
from ..field import ext as E
from ..field import gl
from ..kernels import poseidon as kp
from ..prover.fri import _HALF, _mul_u64
from .mesh import Mesh


def layer_inv2x_padded(m_l: int, shift: int) -> np.ndarray:
    """inv2x[j] = 1/(2*shift*w^j) for j < h, zero-padded to m_l so the
    array shards identically to the layer values."""
    h = m_l // 2
    w_inv = gl.s_inv(gl.root_of_unity(m_l.bit_length() - 1))
    vals = _mul_u64(powers_u64(w_inv, h), gl.s_inv((2 * shift) % gl.P))
    return np.concatenate([np.asarray(vals, dtype=np.uint64),
                           np.zeros(h, dtype=np.uint64)])


def make_sharded_fri_layer(mesh: Mesh, m_l: int, cap_height: int):
    """One sharded FRI layer step: commit the current layer (cap out) and
    fold it with beta (next layer out, evenly resharded).

    run(values, inv2x, beta): values = (re, im), each a list of per-shard
    (m_l/d,) blocks; inv2x the per-shard blocks of ``layer_inv2x_padded``;
    beta a python-int pair.  Returns (caps, next_values): caps a list of
    python-int digests, next_values the (m_l/2,) layer as (re, im) block
    lists."""
    d = mesh.shape["sp"]
    if d < 2 or d % 2:
        raise ValueError("the sp axis must be even")
    h = m_l // 2
    blk = m_l // d
    cap_total = 1 << min(cap_height, h.bit_length() - 1)
    if cap_total < d // 2:
        raise ValueError(f"cap {cap_total} smaller than the {d // 2} low "
                         "shards")
    cps = cap_total // (d // 2)          # cap entries per low shard
    if blk < cps or blk % cps:
        raise ValueError(f"block {blk} does not split into {cps} cap entries")
    low = range(d // 2)
    lowperm = [(i + d // 2, i) for i in low]
    rebalance_a = [(s, 2 * s) for s in low]
    rebalance_b = [(s, 2 * s + 1) for s in low]

    def run(values, inv2x, beta):
        re, im = values
        # 1. pair exchange: low shard s gains the partner block (rows j+h)
        pre, pim = (mesh.ppermute(v, lowperm) for v in (re, im))
        # 2. layer commit on the low shards: leaf rows [v0.re, v0.im,
        #    v1.re, v1.im], a local subtree down to cps digests each
        subroots = []
        for s in low:
            leaf = torch.stack([re[s], im[s], pre[s], pim[s]], dim=1)
            dig = kp.leaf_hash(leaf)
            if blk > cps:
                dig = kp.two_to_one_levels(dig, (blk // cps).bit_length() - 1)[-1]
            subroots.append(dig)
        caps = [tuple(int(x) for x in row)
                for row in gl.to_u64(mesh.gather(subroots))]
        # 3. fold: out = (v0 + v1)/2 + beta * (v0 - v1) * inv2x
        halves = ([None] * d, [None] * d), ([None] * d, [None] * d)
        for s in low:
            v0, v1 = (re[s], im[s]), (pre[s], pim[s])
            dev = re[s].device
            out = E.add(E.mul_base(E.add(v0, v1), gl.const(_HALF, device=dev)),
                        E.mul(E.const(beta, re[s]),
                              E.mul_base(E.sub(v0, v1), inv2x[s])))
            for c in (0, 1):
                halves[0][c][s] = out[c][:blk // 2]
                halves[1][c][s] = out[c][blk // 2:]
        # 4. rebalance: block halves to shards 2s and 2s+1
        nxt = []
        for c in (0, 1):
            a = mesh.ppermute(halves[0][c], rebalance_a)
            b = mesh.ppermute(halves[1][c], rebalance_b)
            nxt.append([a[s] if s % 2 == 0 else b[s] for s in range(d)])
        return caps, tuple(nxt)

    run.layer_size = m_l
    return run


def fri_chain_plan(m: int, d: int, final_domain: int):
    """Layer sizes the sharded chain can fold (block sizes must stay even
    and divisible); the remainder folds on one device, like the
    single-device tail of the hybrid prover."""
    sizes = []
    size = m
    while size > final_domain and (size // d) % 2 == 0 and size // d >= 2:
        sizes.append(size)
        size //= 2
    return sizes, size
