"""The wire commitment (INTT -> LDE -> Poseidon Merkle cap) over a
(dp, sp) mesh.

Counterpart of ``tpu_acir_prover/parallel/pipeline.py``.  dp shards
independent witness batches; sp shards the polynomial domain (trace rows).
Each four-step NTT takes one all_to_all; leaf hashing stays local; each sp
shard contributes one subtree root to the cap through an all_gather.

Layout algebra (four-step NTT, see ``parallel/mesh.py``):
  input  x[i] on an (A, B) grid at [i1, i2], i = i1*B + i2, i2 sharded;
  output X[k] on a (B, A) grid at [k2, k1], k = k1 + A*k2, k1 sharded.
Since k sits at row-major position k2*A + k1 of the transposed grid, an
all_gather along the k1 axis followed by a flatten is natural order.  The
sharded Merkle leaf order is the device-major local flatten
l = s*(B*A/d) + k2*(A/d) + k1_loc, a fixed public permutation of the domain
(``leaf_permutation`` below).
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.compile import powers_u64
from ..field import gl
from ..prover.merkle import leaf_digests, merkle_levels
from ..prover.ntt import ntt
from .mesh import Mesh, _twiddle_matrix


def grid_dims(n: int):
    """Split n = A*B with A <= B, both powers of two."""
    lg = n.bit_length() - 1
    A = 1 << (lg // 2)
    return A, n // A


def leaf_permutation(m: int, d: int) -> np.ndarray:
    """leaf index l -> domain index k for the sharded commit of an m-point
    LDE over d sp-shards (device-major transposed four-step layout)."""
    A, B = grid_dims(m)
    al = A // d
    s, k2, k1l = np.meshgrid(np.arange(d), np.arange(B), np.arange(al),
                             indexing="ij")
    k1 = s * al + k1l
    return (k1 + A * k2).reshape(-1)


def ntt_grid(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """NTT along axis 0 of a (rows, X, C) tensor."""
    s = x.shape
    return ntt(x.reshape(s[0], -1), inverse=inverse).reshape(s)


def make_sharded_wire_commit(mesh: Mesh, n: int, num_cols: int,
                             rate_bits: int = 3):
    """The (dp, sp)-sharded wire commitment of batches of (n, C) matrices.

    run(wires): a (Bt, n, C) int64 tensor, Bt divisible by the dp size.
    Shard (i, j) takes dp block i of the batches and sp block j of the
    columns of each (A, B) grid.  Returns (caps, evals): caps a (Bt, d, 4)
    tensor on the first shard's device, one subtree root per sp shard;
    evals the per-shard (Bt/dp, Bm, Am/d, C) LDE blocks in the sharded
    transposed layout."""
    if tuple(mesh.axis_names) != ("dp", "sp"):
        raise ValueError(f"needs a (dp, sp) mesh, got {mesh.axis_names}")
    dp, d = mesh.shape["dp"], mesh.shape["sp"]
    m = n << rate_bits
    A, B = grid_dims(n)
    Am, Bm = grid_dims(m)
    if A % d or B % d or Am % d or Bm % d:
        raise ValueError(f"grids ({A}, {B}) and ({Am}, {Bm}) do not split "
                         f"over {d} sp shards")
    tw_i = _twiddle_matrix(A, B, inverse=True)
    tw_f = _twiddle_matrix(Am, Bm, inverse=False)
    shift_pows = powers_u64(gl.MULTIPLICATIVE_GENERATOR, m)

    def cols(u64, width, s):
        p = mesh.axis_index("sp", s)
        return gl.from_u64(u64[:, p * (width // d):(p + 1) * (width // d)],
                           mesh.devices[s])

    consts = [(cols(tw_i, B, s), cols(tw_f, Bm, s),
               gl.from_u64(shift_pows, dev))
              for s, dev in enumerate(mesh.devices)]

    def four_step(xs, tws, inverse):
        """(Agrid, Bgrid/d, C) column blocks -> (Bgrid, Agrid/d, C)."""
        g = [gl.mul(ntt_grid(x, inverse), tw[:, :, None])
             for x, tw in zip(xs, tws)]
        g = mesh.all_to_all(g, "sp", split_axis=0, concat_axis=1)
        return [ntt_grid(x.transpose(0, 1).contiguous(), inverse) for x in g]

    def per_batch(ws):
        # INTT, then the coefficients gathered along k1: the row-major
        # flatten of [j2, j1] is the natural coefficient index j2*A + j1
        coeffs = four_step(ws, [c[0] for c in consts], True)
        full = mesh.all_gather(coeffs, "sp", dim=1)
        grids = []
        for s, (x, (_, _, sp)) in enumerate(zip(full, consts)):
            C = x.shape[-1]
            padded = torch.cat([x.reshape(n, C),
                                torch.zeros((m - n, C), dtype=torch.int64,
                                            device=x.device)])
            grid = gl.mul(padded, sp[:, None]).reshape(Am, Bm, C)
            p = mesh.axis_index("sp", s)
            grids.append(grid[:, p * (Bm // d):(p + 1) * (Bm // d)]
                         .contiguous())
        evals = four_step(grids, [c[1] for c in consts], False)
        roots = []
        for e in evals:
            leaves = e.reshape(-1, e.shape[-1])
            roots.append(merkle_levels(leaf_digests(leaves), 1)[-1])
        return mesh.all_gather(roots, "sp"), evals     # (d, 4) per shard

    def run(wires: torch.Tensor):
        Bt = wires.shape[0]
        if Bt % dp:
            raise ValueError(f"{Bt} batches over {dp} dp shards")
        per = Bt // dp
        grid = wires.reshape(Bt, A, B, num_cols)
        caps = [None] * Bt
        evals = [[] for _ in mesh.devices]
        for t in range(per):
            # every dp group commits its t-th batch at once
            ws = []
            for s, dev in enumerate(mesh.devices):
                i, p = mesh.axis_index("dp", s), mesh.axis_index("sp", s)
                ws.append(grid[i * per + t, :, p * (B // d):(p + 1) * (B // d)]
                          .to(dev).contiguous())
            roots, ev = per_batch(ws)
            for s in range(mesh.size):
                evals[s].append(ev[s])
                if mesh.axis_index("sp", s) == 0:
                    b = mesh.axis_index("dp", s) * per + t
                    caps[b] = roots[s].to(mesh.devices[0])
        return torch.stack(caps), [torch.stack(e) for e in evals]

    run.grid = (A, B, Am, Bm)
    return run
