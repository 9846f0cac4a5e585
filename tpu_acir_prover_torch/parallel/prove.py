"""The multi-device prover: every heavy phase of ``prove()`` over a mesh of
torch devices, with explicit collectives.

Counterpart of ``tpu_acir_prover/parallel/prove.py``.  The trace-row /
evaluation-domain axis ("sp") is sharded as contiguous row blocks, shard s
on its own mesh device; one process drives every shard (``parallel/mesh.py``):

  - NTT/LDE: the four-step (Bailey) decomposition, whose butterfly
    exchanges are all_to_alls and whose FLOPs are local radix-2/4 NTTs; a
    last all_to_all restores natural-order row blocks, so Merkle leaves,
    caps, paths and the whole proof are byte-identical to the single-device
    prover.  Domains whose grid does not split over the shards (tiny ones)
    are gathered, transformed on one device and scattered: same values.
  - Merkle commit: leaf hash and subtree levels local per shard, up to
    max(cap, S) global nodes; above that the S shard roots are gathered
    and finished on the first device.  The local levels of the shards
    concatenate to the global levels, since the row blocks are contiguous.
  - round 2: row-local per shard; the two cross-row scans (Z's product,
    LogUp's running sum) are a local scan plus exclusive cross-shard
    offsets from the all_gathered shard totals.
  - quotient: row-local per shard; the g*x shift of the Z oracle is one
    ppermute of ``rate`` rows; t(x)'s coset INTT is the four-step again.
  - openings: local column-dot partials, gathered and summed.
  - FRI combine: row-local; F is gathered to the first device, where the
    FRI layers, the grind and the final polynomial run as on one device.

Field arithmetic is exact mod p, so every reassociation (local scans plus
offsets, partial sums, four-step vs radix-2 NTT) gives the same values.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..circuit.compile import CompiledCircuit, powers_u64
from ..field import ext as E
from ..field import gl
from ..field.gl import MULTIPLICATIVE_GENERATOR
from ..kernels import poseidon as kp
from ..prover.config import ProofConfig, STANDARD_CONFIG
from ..prover.merkle import leaf_digests, merkle_levels
from ..prover.ntt import coset_lde, intt, ntt
from ..prover.prove import (QUOTIENT_CHUNK, Oracle, ProvingKey, _fold,
                            _prefix, open_body, prove, round2_columns,
                            round2_factors)
from .mesh import Mesh, _twiddle_matrix
from .pipeline import grid_dims, ntt_grid


def _fourstep_ok(size: int, S: int) -> bool:
    A, B = grid_dims(size)
    return A % S == 0 and B % S == 0


def _take(blocks, idx: np.ndarray, device) -> torch.Tensor:
    """Rows ``idx`` (global indices) of a row-blocked matrix, on
    ``device``."""
    blk = blocks[0].shape[0]
    out = torch.empty((len(idx), blocks[0].shape[1]), dtype=torch.int64,
                      device=device)
    owner = idx // blk
    for s in np.unique(owner):
        sel = np.nonzero(owner == s)[0]
        b = blocks[s]
        rows = b.index_select(0, torch.as_tensor(idx[sel] - s * blk,
                                                 device=b.device))
        out[torch.as_tensor(sel, device=device)] = rows.to(device)
    return out


class ShardedTree:
    """Merkle tree of a row-blocked (M, C) matrix: each shard's leaves and
    local levels on its device, the levels above the shard roots (if any)
    on the first.  The same interface as ``prover/merkle.MerkleTree``."""

    def __init__(self, mesh: Mesh, leaves, local, top):
        self.mesh = mesh
        self.leaves = leaves   # per shard (M/S, C)
        self.local = local     # per level, per shard (size/S, 4)
        self.top = top         # per level above the roots, (size, 4)

    @property
    def num_leaves(self) -> int:
        return sum(x.shape[0] for x in self.leaves)

    @property
    def cap(self) -> torch.Tensor:
        return self.top[-1] if self.top else self.mesh.gather(self.local[-1])

    def cap_u64(self) -> np.ndarray:
        return gl.to_u64(self.cap)

    def rows_and_paths(self, indices):
        """As ``MerkleTree.rows_and_paths``: the rows and sibling digests of
        every level are fetched from the shards that hold them, then one
        device->host copy."""
        idx = np.asarray(indices, dtype=np.int64)
        dev = self.mesh.devices[0]
        levels = self.local + [[t] for t in self.top]
        parts = [_take(self.leaves, idx, dev)]
        for lev, blocks in enumerate(levels[:-1]):
            parts.append(_take(blocks, (idx >> lev) ^ 1, dev))
        flat = gl.to_u64(torch.cat(parts, dim=1))
        c = self.leaves[0].shape[1]
        paths = [[flat[q, c + 4 * lev:c + 4 * (lev + 1)]
                  for lev in range(len(levels) - 1)]
                 for q in range(len(idx))]
        return flat[:, :c], paths


class _Shard:
    """Shard s of a ShardedProvingKey as the phase bodies see a key: its
    row blocks of the domain tables (``ProvingKey.domain_tables``) and of
    the wire indices, and its copies of the small replicated tensors, on its
    device; every other attribute reads through to the key, which it holds
    weakly."""

    _dev = ProvingKey._dev
    _ext = ProvingKey._ext
    quotient_rows = ProvingKey.quotient_rows
    fri_combine = ProvingKey.fri_combine

    def __init__(self, key, s: int):
        # a weak proxy: the key holds its shards, and a strong reference
        # back would keep a dropped key's device tensors until Python's
        # cycle collector runs
        self._key = weakref.proxy(key)
        self.device = key.mesh.devices[s]
        for name in key.domain_tables + ("wire_idx",):
            setattr(self, name, getattr(key, name)[s])
        self.k = key.k.to(self.device)

    def __getattr__(self, name):
        return getattr(self._key, name)


class ShardedProvingKey(ProvingKey):
    """A ProvingKey whose domain-axis tensors are contiguous row blocks over
    a one-axis mesh, shard s on the mesh's device s, and whose phases run
    shard by shard with explicit collectives.  Replicated values (the
    challenges' tables, the FRI layers after the combine) live on the first
    shard's device.  Oracles hold lists of blocks; their trees are
    ``ShardedTree``s."""

    fusable = False

    def __init__(self, compiled: CompiledCircuit,
                 config: ProofConfig = STANDARD_CONFIG, *, mesh: Mesh):
        if mesh.axis_names != ("sp",):
            raise ValueError(f"needs a one-axis 'sp' mesh, got "
                             f"{mesh.axis_names}")
        S = mesh.size
        if compiled.n % S:
            raise ValueError(f"trace rows {compiled.n} do not divide over "
                             f"{S} shards")
        self.mesh = mesh
        self.S = S
        self._consts = {}
        super().__init__(compiled, config, device=mesh.devices[0])
        nb = self.n // S
        self.wire_idx = [self.wire_idx[:, s * nb:(s + 1) * nb]
                         .to(dev, copy=True).contiguous()
                         for s, dev in enumerate(mesh.devices)]
        self.shards = [_Shard(self, s) for s in range(S)]

    def _rows(self, u64: np.ndarray):
        blk = u64.shape[0] // self.S
        return [gl.from_u64(u64[s * blk:(s + 1) * blk], dev)
                for s, dev in enumerate(self.mesh.devices)]

    def _const(self, kind: str, size: int):
        """Per-shard blocks of the twiddle matrices (column blocks) and the
        coset shift powers (row blocks) of a domain size."""
        key = (kind, size)
        if key not in self._consts:
            if kind in ("tw_i", "tw_f"):
                A, B = grid_dims(size)
                tw = _twiddle_matrix(A, B, inverse=kind == "tw_i")
                w = B // self.S
                self._consts[key] = [gl.from_u64(tw[:, s * w:(s + 1) * w], d)
                                     for s, d in enumerate(self.mesh.devices)]
            else:
                g = MULTIPLICATIVE_GENERATOR
                base = gl.s_inv(g) if kind == "shift_inv" else g
                self._consts[key] = self._rows(powers_u64(base, size))
        return self._consts[key]

    # ---- sharded polynomial kernels -----------------------------------------

    def _fourstep_tail(self, grid, size: int, inverse: bool, tw):
        """(A, B/S, C) column blocks of the (A, B) grid -> (size/S, C)
        natural row blocks: column NTT, twiddle, all_to_all, row NTT,
        all_to_all."""
        mesh = self.mesh
        g = [gl.mul(ntt_grid(x, inverse), t[:, :, None])
             for x, t in zip(grid, tw)]
        g = mesh.all_to_all(g, "sp", split_axis=0, concat_axis=1)
        # (A/S, B, C) -> rows k2: (B, A/S, C)
        x = [ntt_grid(y.transpose(0, 1).contiguous(), inverse) for y in g]
        del g
        x = mesh.all_to_all(x, "sp", split_axis=0, concat_axis=1)
        return [y.reshape(-1, y.shape[-1]) for y in x]   # (B/S, A, C)

    def _intt_blocks(self, vals, size: int):
        """Natural-order INTT of a row-blocked (size, C) matrix."""
        if not _fourstep_ok(size, self.S):
            return self.mesh.scatter(intt(self.mesh.gather(vals)))
        A, B = grid_dims(size)
        grid = self.mesh.all_to_all(
            [v.reshape(A // self.S, B, v.shape[1]) for v in vals],
            "sp", split_axis=1, concat_axis=0)          # (A, B/S, C)
        return self._fourstep_tail(grid, size, True,
                                   self._const("tw_i", size))

    def _coset_lde_blocks(self, coeffs):
        """Coset LDE of row-blocked (n, C) coefficients -> (m/S, C) row
        blocks of the evaluations.  Each shard builds only its (Am, Bm/S,
        C) column block of the zero-padded (Am, Bm) grid from the gathered
        coefficients."""
        n, m, S = self.n, self.m, self.S
        scaled = [gl.mul(c, sp[:, None])
                  for c, sp in zip(coeffs, self._const("shift", n))]
        if not _fourstep_ok(m, S):
            full = self.mesh.gather(scaled)
            pad = torch.zeros((m - n, full.shape[1]), dtype=torch.int64,
                              device=full.device)
            return self.mesh.scatter(ntt(torch.cat([full, pad])))
        Am, Bm = grid_dims(m)
        w = Bm // S
        full = self.mesh.all_gather(scaled)                   # (n, C)
        del scaled
        grids = []
        for s, f in enumerate(full):
            C = f.shape[1]
            r = -(-n // Bm)                  # grid rows that hold coeffs
            head = torch.cat([f, f.new_zeros((r * Bm - n, C))]) \
                if r * Bm > n else f
            blk = head.reshape(r, Bm, C)[:, s * w:(s + 1) * w]
            grids.append(torch.cat([blk, f.new_zeros((Am - r, w, C))]))
        del full
        return self._fourstep_tail(grids, m, False, self._const("tw_f", m))

    def _coset_intt_blocks(self, vals, size: int):
        """Coset INTT of a row-blocked (size, C) matrix -> row-blocked
        coefficients."""
        loc = self._intt_blocks(vals, size)
        return [gl.mul(x, sp[:, None])
                for x, sp in zip(loc, self._const("shift_inv", size))]

    def _merkle_tree(self, lde) -> ShardedTree:
        """Local leaf digests and subtrees down to max(cap, S) global nodes;
        above that, the shard roots gathered and hashed up to the cap."""
        m, S = self.m, self.S
        cap_size = 1 << min(self.config.cap_height, m.bit_length() - 1)
        stop_g = max(cap_size, S)
        per_shard = [merkle_levels(leaf_digests(x), max(1, stop_g // S))
                     for x in lde]
        local = [list(level) for level in zip(*per_shard)]
        size_g = stop_g if m > stop_g else m
        top = []
        if size_g > cap_size:
            roots = self.mesh.gather(local[-1])              # (S, 4)
            top = kp.two_to_one_levels(
                roots, (size_g // cap_size).bit_length() - 1)
        return ShardedTree(self.mesh, lde, local, top)

    def _exclusive_scan(self, op, xs, fill):
        """Exclusive scan of a row-blocked (n,) ext vector: a local
        inclusive scan per shard, then each shard's offset, the op over the
        all_gathered totals of the shards before it."""
        incl = [_prefix(op, x, fill) for x in xs]
        tot = self.mesh.all_gather([torch.stack([c[-1] for c in y])
                                    for y in incl], tiled=False)
        out = []
        for s, (y, g) in enumerate(zip(incl, tot)):
            if s == 0:
                off = tuple(torch.full((1,), f, dtype=torch.int64,
                                       device=y[0].device) for f in fill)
            else:
                off = _fold(op, [(g[j, 0:1], g[j, 1:2]) for j in range(s)])
                y = op(y, off)
            out.append(tuple(torch.cat([o, c[:-1]]) for o, c in zip(off, y)))
        return out

    # ---- phases --------------------------------------------------------------

    def build_wires(self, vals: torch.Tensor, mcol=None):
        nb = self.n // self.S
        out = []
        for s, sh in enumerate(self.shards):
            w = vals.to(sh.device)[sh.wire_idx]
            if mcol is not None:
                w = torch.cat([w, mcol[s * nb:(s + 1) * nb]
                               .to(sh.device).reshape(1, nb)])
            out.append(w.T.contiguous())
        return out

    def commit(self, values, from_coeffs: bool = False) -> Oracle:
        coeffs = values if from_coeffs else self._intt_blocks(values, self.n)
        lde = self._coset_lde_blocks(coeffs)
        return Oracle(coeffs, lde, self._merkle_tree(lde))

    def round2_phase(self, wires, beta, gamma, lam):
        parts = [round2_factors(sh, w, sh._ext(beta), sh._ext(gamma),
                                sh._ext(lam) if self.has_lookups else None)
                 for sh, w in zip(self.shards, wires)]
        z = self._exclusive_scan(E.mul, [p[0] for p in parts], (1, 0))
        s_run = self._exclusive_scan(E.add, [p[5] for p in parts], (0, 0)) \
            if self.has_lookups else [None] * self.S
        return [round2_columns(sh, zs, *p[1:5], ss)
                for sh, p, zs, ss in zip(self.shards, parts, z, s_run)]

    def quotient_phase(self, wires_lde, z_lde, pub_values, beta, gamma, lam,
                       alpha):
        n, m, S = self.n, self.m, self.S
        rate = self.config.rate
        blk = m // S
        # the public-input column's LDE, once, scattered as row blocks
        pub = self._dev(np.array(pub_values, dtype=np.uint64))
        pi = torch.cat([gl.neg(pub), torch.zeros(n - pub.shape[0],
                                                 dtype=torch.int64,
                                                 device=pub.device)])
        pi_lde = self.mesh.scatter(
            coset_lde(intt(pi.reshape(n, 1)), self.config.rate_bits)[:, 0])
        # z at the rows + rate (g*x): each shard sends its first rate rows
        # to the shard before it
        recv = self.mesh.ppermute([z[:rate] for z in z_lde],
                                  [(s, (s - 1) % S) for s in range(S)])
        const = self.constants_oracle.lde
        chunk = min(QUOTIENT_CHUNK, blk)
        t = []
        for s, sh in enumerate(self.shards):
            zg = torch.cat([z_lde[s][rate:], recv[s]])
            ch = (sh._ext(beta), sh._ext(gamma),
                  sh._ext(lam) if self.has_lookups else None,
                  E.powers_table(sh._ext(alpha), self.num_constraints))
            t_re = torch.empty(blk, dtype=torch.int64, device=sh.device)
            t_im = torch.empty_like(t_re)
            for st in range(0, blk, chunk):
                sl = slice(st, st + chunk)
                t_re[sl], t_im[sl] = sh.quotient_rows(
                    const[s][sl], wires_lde[s][sl], z_lde[s][sl], zg[sl],
                    pi_lde[s][sl], sh.x_lde[sl], sh.zh_inv_lde[sl],
                    sh.zh_lde[sl], *ch)
            t.append(torch.stack([t_re, t_im], dim=1))
        # t(x)'s coefficients, gathered; shard s keeps rows [s*n/S,
        # (s+1)*n/S) of each chunk k (rows k*n ..) as its block of the
        # (n, 2 * NUM_CHUNKS) quotient columns
        tc = self.mesh.all_gather(self._coset_intt_blocks(t, m))
        nb = n // S
        out = []
        for s, full in enumerate(tc):
            rows = [full[k * n + s * nb:k * n + (s + 1) * nb]
                    for k in range(self.num_chunks)]
            out.append(torch.stack([r[:, 0] for r in rows] +
                                   [r[:, 1] for r in rows], dim=1))
        return out

    def open_at(self, oracle: Oracle, pows):
        nb = self.n // self.S
        parts = []
        for s, (c, dev) in enumerate(zip(oracle.coeffs, self.mesh.devices)):
            p = tuple(x[s * nb:(s + 1) * nb].to(dev) for x in pows)
            parts.append(torch.stack(open_body(c, p))[None])   # (1, 2, C)
        re64, im64 = gl.to_u64(gl.sum_axis(self.mesh.gather(parts), 0))
        return [(int(x), int(y)) for x, y in zip(re64, im64)]

    def fri_combine(self, lde_list, fri_alpha, ys, ys_next, zeta, gzeta,
                    z_lde):
        outs = [sh.fri_combine([o[s] for o in lde_list], fri_alpha, ys,
                               ys_next, zeta, gzeta, z_lde[s])
                for s, sh in enumerate(self.shards)]
        # F gathered to the first device: the FRI layers, the grind and the
        # final polynomial run there, as on one device
        return tuple(self.mesh.gather([o[c] for o in outs]) for c in (0, 1))


def prove_sharded(spk: ShardedProvingKey, external_values: np.ndarray,
                  check_constraints: bool = False, timer=None):
    """The proof of ``prove.prove`` (same pipeline and transcript) with the
    sharded key's phases running over its mesh."""
    return prove(spk, external_values, check_constraints=check_constraints,
                 timer=timer)
