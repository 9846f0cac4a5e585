"""The layout of a circuit: the part of the port's ``compile_circuit``
(``circuit/compile.py``) that fixes the trace length, the selectors, the
wire routing, the copy permutation's sigma columns, the shifts and the
lookup rows and table, copied as it stood.  The witness generator's
schedule is left out: the reference solves the generators plainly
(``reference.solve``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..field import gl as _gl
from ..field.gl import P
from ..field.gl_np import make_gl
from .builder import (CircuitBuilder, NUM_PAIRS, NUM_SELECTORS, NUM_WIRES,
                      SEL_Q0, SEL_QC, SEL_QLK, SEL_QM0)

_GNP = make_gl(np)

MIN_ROWS = 16


def powers_u64(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] mod p as numpy uint64, via
    vectorized log-doubling on 32-bit limbs."""
    out_lo = np.array([1], dtype=np.uint32)
    out_hi = np.array([0], dtype=np.uint32)
    cur = base % P
    while out_lo.shape[0] < n:
        k = out_lo.shape[0]
        c = _GNP.const(cur, (k,))
        nlo, nhi = _GNP.mul((out_lo, out_hi), c)
        out_lo = np.concatenate([out_lo, nlo])
        out_hi = np.concatenate([out_hi, nhi])
        cur = (cur * cur) % P
    return _GNP.to_u64((out_lo[:n], out_hi[:n]))


@dataclass
class CircuitShape:
    n: int
    log_n: int
    selectors: np.ndarray        # (NUM_SELECTORS, n) uint64
    wire_vars: np.ndarray        # (NUM_WIRES, n) int64 variable ids
    sigma: np.ndarray            # (NUM_WIRES, n) uint64
    k_shifts: Tuple[int, ...]
    num_public_inputs: int
    lookup_bits: int
    lookup_rows: np.ndarray      # int64 row indices with qLK = 1
    table: Optional[np.ndarray]  # (n,) uint64, or None


def circuit_shape(builder: CircuitBuilder) -> CircuitShape:
    num_pub = len(builder.public_inputs)
    num_gate_rows = len(builder.rows)
    num_lookup_rows = -(-len(builder.pending_lookups) // NUM_WIRES) \
        if builder.pending_lookups else 0
    total = num_pub + num_gate_rows + num_lookup_rows
    n = max(MIN_ROWS, 1 << (total - 1).bit_length())
    if builder.lookup_bits and num_lookup_rows:
        n = max(n, 1 << builder.lookup_bits)
    log_n = n.bit_length() - 1

    selectors = np.zeros((NUM_SELECTORS, n), dtype=np.uint64)
    wire_vars = np.zeros((NUM_WIRES, n), dtype=np.int64)  # 0 = zero var

    # PI rows first: q0 = 1, w0 = pub var; PI(x) supplies -pub_j at row j.
    for j, pv in enumerate(builder.public_inputs):
        selectors[SEL_Q0, j] = 1
        wire_vars[0, j] = pv
    for r, row in enumerate(builder.rows):
        i = num_pub + r
        for k in range(NUM_PAIRS):
            selectors[SEL_QM0 + k, i] = row.qm[k]
        for k in range(NUM_WIRES):
            selectors[SEL_Q0 + k, i] = row.q[k]
            if row.wires[k] is not None:
                wire_vars[k, i] = row.wires[k]
        selectors[SEL_QC, i] = row.qc

    # lookup rows: flush pending lookups W per row, qLK = 1, padding -> var 0
    base = num_pub + num_gate_rows
    lookup_rows = np.arange(base, base + num_lookup_rows, dtype=np.int64)
    for idx, v in enumerate(builder.pending_lookups):
        r, c = divmod(idx, NUM_WIRES)
        wire_vars[c, base + r] = v
    selectors[SEL_QLK, lookup_rows] = 1

    table = None
    if builder.lookup_bits and num_lookup_rows:
        table = np.arange(n, dtype=np.uint64)
        table[1 << builder.lookup_bits:] = 0

    # identity values: id[col*n + row] = k_col * omega^row
    omega_pows = powers_u64(_gl.root_of_unity(log_n), n)
    g = _gl.MULTIPLICATIVE_GENERATOR
    k_shifts = tuple(pow(g, i, P) for i in range(NUM_WIRES))
    ids = np.empty((NUM_WIRES, n), dtype=np.uint64)
    for col, k in enumerate(k_shifts):
        klo, khi = _GNP.const(k, (n,))
        plo = (omega_pows & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        phi = (omega_pows >> np.uint64(32)).astype(np.uint32)
        ids[col] = _GNP.to_u64(_GNP.mul((klo, khi), (plo, phi)))

    flat_vars = wire_vars.reshape(-1)  # slot s = col*n + row
    order = np.argsort(flat_vars, kind="stable")
    sorted_vars = flat_vars[order]
    # next-in-group cyclic permutation
    boundaries = np.nonzero(np.diff(sorted_vars))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [flat_vars.size]])
    nxt = np.arange(1, flat_vars.size + 1)
    nxt[ends - 1] = starts  # wrap each group
    perm = np.empty(flat_vars.size, dtype=np.int64)
    perm[order] = order[nxt]
    sigma = ids.reshape(-1)[perm].reshape(NUM_WIRES, n)

    return CircuitShape(
        n=n, log_n=log_n, selectors=selectors, wire_vars=wire_vars,
        sigma=sigma, k_shifts=k_shifts, num_public_inputs=num_pub,
        lookup_bits=builder.lookup_bits if num_lookup_rows else 0,
        lookup_rows=lookup_rows, table=table)
