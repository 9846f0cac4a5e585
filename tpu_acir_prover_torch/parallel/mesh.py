"""A mesh of torch devices driven from one process, its collectives, and
the four-step NTT over it.

Counterpart of ``tpu_acir_prover/parallel/mesh.py``.  The JAX package runs
its sharded programs under ``shard_map``: one controller, a ``Mesh`` of
devices and explicit collectives.  The port keeps that model.  A sharded
tensor is a python list with one tensor per shard, each on its shard's
device, in the mesh's row-major order; the collectives are tensor moves
on such lists:

  all_gather  the group's shards concatenated (or stacked) on every member;
  all_to_all  every shard split along one axis, piece j to member j, the
              received pieces concatenated along another axis;
  ppermute    shard src's tensor to shard dst for each (src, dst) pair;
              a member that receives nothing gets zeros, as in JAX.

A mesh may name one device several times: every shard then lives on it,
and the moves between them are copies on that device.  Over several cards
the same moves are peer copies.

Axes, as in the JAX package: ``sp`` shards the polynomial evaluation
domain (the trace rows), ``dp`` independent witness batches.

The four-step (Bailey) NTT views a size-n domain as an (a, b) matrix: a
column NTT of size a, a twiddle multiply, one all_to_all, a row NTT of size
b; the butterfly exchanges become one collective.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.compile import powers_u64
from ..field import gl
from ..prover.ntt import ntt
from ..prover.prove import resolve_device


class Mesh:
    """Torch devices on named axes; each axis has a power-of-two size.

    ``devices`` is a list (one axis) or a nested list (one level per axis)
    of devices or device names; shard i is the i-th device in row-major
    order.  A CUDA device with no card raises."""

    def __init__(self, devices, axis_names=("sp",)):
        grid = np.array(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        for name, size in zip(axis_names, grid.shape):
            if size < 1 or size & (size - 1):
                raise ValueError(f"mesh axis {name!r} has {size} devices: "
                                 "each axis needs a power of two")
        self.axis_names = tuple(axis_names)
        self.dims = grid.shape
        self.shape = dict(zip(self.axis_names, self.dims))
        self.devices = [resolve_device(d) for d in grid.reshape(-1)]

    @classmethod
    def on(cls, device, shards: int) -> "Mesh":
        """A one-axis ``sp`` mesh of ``shards`` shards, all on one device."""
        return cls([device] * shards)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_index(self, axis: str, shard: int) -> int:
        """The position of flat shard ``shard`` along ``axis``."""
        k = self.axis_names.index(axis)
        return int(np.unravel_index(shard, self.dims)[k])

    def groups(self, axis: str):
        """The flat shard indices of each group along ``axis``, every group
        ordered by position on the axis."""
        k = self.axis_names.index(axis)
        idx = np.moveaxis(np.arange(self.size).reshape(self.dims), k, -1)
        return [[int(i) for i in g] for g in idx.reshape(-1, self.dims[k])]

    # ---- between the host or one device and the shards ---------------------

    def scatter(self, full: torch.Tensor, dim: int = 0):
        """One axis mesh: ``full`` split into equal contiguous blocks along
        ``dim``, block s copied to shard s's device (a copy of its own,
        even on the device ``full`` lies on)."""
        blk = full.shape[dim] // self.size
        if blk * self.size != full.shape[dim]:
            raise ValueError(f"{full.shape[dim]} rows over {self.size} shards")
        return [full.narrow(dim, s * blk, blk).to(d, copy=True).contiguous()
                for s, d in enumerate(self.devices)]

    def gather(self, xs, dim: int = 0) -> torch.Tensor:
        """One axis mesh: the shards concatenated along ``dim`` on the first
        shard's device."""
        return torch.cat([x.to(self.devices[0]) for x in xs], dim)

    # ---- collectives --------------------------------------------------------

    def all_gather(self, xs, axis: str = "sp", dim: int = 0,
                   tiled: bool = True):
        """Each member gets its group's shards concatenated along ``dim``
        (``tiled``) or stacked on a new leading axis.  Members on one device
        share one read-only result."""
        out = [None] * self.size
        for g in self.groups(axis):
            made = {}
            for j in g:
                dev = self.devices[j]
                if dev not in made:
                    parts = [xs[i].to(dev) for i in g]
                    made[dev] = torch.cat(parts, dim) if tiled else \
                        torch.stack(parts)
                out[j] = made[dev]
        return out

    def all_to_all(self, xs, axis: str, split_axis: int, concat_axis: int):
        """Every member splits its shard into as many pieces as the group
        has members along ``split_axis``; member j gets piece j of every
        member, concatenated along ``concat_axis`` in member order."""
        out = [None] * self.size
        for g in self.groups(axis):
            pieces = [xs[i].chunk(len(g), split_axis) for i in g]
            for p, j in enumerate(g):
                dev = self.devices[j]
                out[j] = torch.cat([pc[p].to(dev) for pc in pieces],
                                   concat_axis)
        return out

    def ppermute(self, xs, perm, axis: str = "sp"):
        """Shard ``src``'s tensor to shard ``dst`` for every (src, dst) of
        ``perm`` (positions along ``axis``); a member that receives nothing
        gets zeros of the sent shape.  Entries of ``xs`` that no pair sends
        may be None."""
        out = [None] * self.size
        for g in self.groups(axis):
            sent = [xs[g[src]] for src, _ in perm]
            for src, dst in perm:
                out[g[dst]] = xs[g[src]].to(self.devices[g[dst]])
            for j in g:
                if out[j] is None:
                    out[j] = torch.zeros_like(sent[0],
                                              device=self.devices[j])
        return out


def _twiddle_matrix(a: int, b: int, inverse: bool) -> np.ndarray:
    """w_n^(i2*k1) twiddles, shape (a, b): rows k1, cols i2 (uint64)."""
    n = a * b
    w = gl.root_of_unity(n.bit_length() - 1)
    if inverse:
        w = gl.s_inv(w)
    rows = powers_u64(w, n)  # w^j for j < n
    out = np.empty((a, b), dtype=np.uint64)
    for k1 in range(a):
        out[k1] = rows[(k1 * np.arange(b)) % n]
    return out


def four_step_ntt_reference(values: torch.Tensor, a: int, b: int,
                            inverse: bool = False) -> torch.Tensor:
    """Single-device four-step NTT (for testing the distributed layout).

    Input: (n,) in natural order x[i1*b + i2].  Output: (n,) with X[k] at
    position k (natural order).  Inverse: the two sub-NTTs divide by a and
    by b, 1/n in all."""
    # (a, b): rows i1, cols i2; NTT_a along axis 0 (columns)
    g = ntt(values.reshape(a, b), inverse=inverse)
    g = gl.mul(g, gl.from_u64(_twiddle_matrix(a, b, inverse), values.device))
    # NTT_b along axis 1: rows i2, cols k1 -> (b, a) rows k2, cols k1;
    # X[k1 + a*k2] = x[k2, k1], so the row-major flatten is natural order
    return ntt(g.T.contiguous(), inverse=inverse).reshape(-1)


def make_sharded_ntt(mesh: Mesh, axis: str, a: int, b: int,
                     inverse: bool = False):
    """The four-step NTT over ``axis`` of the mesh.

    run(blocks): the (a, b) matrix sharded along columns (i2), shard s
    holding columns [s*b/d, (s+1)*b/d) as an (a, b/d) tensor.  Returns the
    (b, a) matrix X'[k2, k1] sharded along columns (k1), shard s an
    (b, a/d) tensor: natural index k = k1 + a*k2 lives at [k2, k1].  One
    all_to_all between the two local NTT phases."""
    d = mesh.shape[axis]
    if a % d or b % d:
        raise ValueError(f"({a}, {b}) grid does not split over {d} shards")
    tw = _twiddle_matrix(a, b, inverse)
    w = b // d
    tws = [gl.from_u64(tw[:, p * w:(p + 1) * w], dev)
           for p, dev in ((mesh.axis_index(axis, s), dev)
                          for s, dev in enumerate(mesh.devices))]

    def run(blocks):
        # local column NTTs and twiddles, (a, b/d) each
        g = [gl.mul(ntt(x, inverse=inverse), t) for x, t in zip(blocks, tws)]
        # row blocks (k1) scatter, column blocks gather -> (a/d, b)
        g = mesh.all_to_all(g, axis, split_axis=0, concat_axis=1)
        return [ntt(x.T.contiguous(), inverse=inverse) for x in g]

    return run
