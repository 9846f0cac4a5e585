"""Circuit compiler: CircuitBuilder -> static prover plan (numpy arrays).

The reference rebuilds its circuit inside every CLI command and runs a
dynamic generator fixpoint during proving (prove_action.rs:18-19, :91-97).
Here compilation happens once and produces only statically-shaped arrays:

  * selectors   (NUM_SELECTORS, n) u64 - qM_0..qM_{P-1}, q_0..q_{W-1}, qC, qLK
  * wire_vars   (NUM_WIRES, n)   int64 - variable id per wire slot
  * sigma       (NUM_WIRES, n)   u64   - permutation polynomial values
  * table       (n,) u64              - lookup table column (iota below 2^B)
  * generator program: ops grouped into (level, opcode) batches, executed
    as vectorized numpy limb math (field/gl_np.py)

so the prover itself is pure array code that jits cleanly.

Sigma construction: wire slot s = col*n + row carries identity value
k_col * omega^row; slots sharing a variable form one cycle and sigma maps
each slot to the identity value of the next slot in its cycle — the
standard PLONK permutation argument, built vectorized with one argsort.

Lookup rows: pending builder lookups are flushed W per row after the gate
rows, with qLK = 1; the multiplicity column is witness-dependent and
computed per prove call (multiplicities()).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from itertools import chain
from typing import List, Optional, Tuple

import numpy as np

from ..field import gl as _gl
from ..field.gl import P
from ..field.gl_np import make_gl
from ..utils.timing import open_timer
from .builder import (CircuitBuilder, GEN_EXTERNAL, GEN_CONST, GEN_ADD,
                      GEN_SUB, GEN_MUL, GEN_MULADDC, GEN_INV, GEN_BIT,
                      GEN_HINT_OUT, GEN_MULMULC, Hint,
                      NUM_WIRES, NUM_PAIRS, NUM_SELECTORS, SEL_QM0, SEL_Q0,
                      SEL_QC, SEL_QLK)

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
    v = _GNP.to_u64((out_lo[:n], out_hi[:n]))
    return v


@dataclass
class GenBatch:
    op: int
    out: np.ndarray   # int64 var ids
    a: np.ndarray
    b: np.ndarray
    const: np.ndarray  # uint64 field constants (or bit positions)


@dataclass
class GenProgram:
    """Flat generator arrays for the native witness core (native/):
    level-sorted execution order with python-hint segments."""
    op: np.ndarray      # int32 (n_ops,)
    out: np.ndarray     # int64
    a: np.ndarray       # int64
    b: np.ndarray       # int64
    const: np.ndarray   # uint64
    order: np.ndarray   # int64: op indices in level order
    segments: List[Tuple[int, int, bool]]  # (start, end, is_hint_segment)
    # per hint segment, its hints in first-use order: (hint id, input
    # vars, output vars, each output's place in the hint's result)
    hint_runs: List[List[Tuple[int, np.ndarray, np.ndarray, List[int]]]] = \
        field(default_factory=list)


@dataclass
class CompiledCircuit:
    n: int                      # number of rows (power of two)
    log_n: int
    num_vars: int
    selectors: np.ndarray       # (NUM_SELECTORS, n) uint64
    wire_vars: np.ndarray       # (NUM_WIRES, n) int64
    sigma: np.ndarray           # (NUM_WIRES, n) uint64  (sigma poly values)
    k_shifts: Tuple[int, ...]   # coset shifts k_0..k_{W-1}
    gen_batches: List[GenBatch]
    hints: List[Hint]
    external_vars: np.ndarray   # int64, in creation order
    public_input_vars: np.ndarray  # int64
    num_public_inputs: int
    lookup_bits: int = 0        # 0 = no lookup argument
    lookup_rows: Optional[np.ndarray] = None  # int64 row indices (qLK = 1)
    table: Optional[np.ndarray] = None        # (n,) uint64 table column
    gen_program: Optional[GenProgram] = None  # native execution plan

    # ---- witness generation (host, batched numpy limbs) -------------------

    def generate_witness(self, external_values: np.ndarray) -> np.ndarray:
        """Fill all variable values from external (ACIR) witness values.

        external_values: uint64 array aligned with external_vars order.
        Returns vals: uint64 array of length num_vars.  Uses the native
        witness core (C, native/witnesscore.c) when available; falls back
        to the batched-numpy path otherwise.

        Both paths run the generators in segments: runs of arithmetic ops
        (C, or numpy batches) between runs of python hints.  Inside an
        enabled timer's span (``utils/timing.open_timer``) the fill counts
        into it ``fill_native_s`` and ``fill_hint_s``, the seconds in
        arithmetic and in hint segments (a hint's ``int()`` conversions and
        the scatter of its outputs included), reading the clock once a
        segment; outside one, not at all.
        """
        if self.gen_program is not None:
            from ..native import get_lib
            if get_lib() is not None:
                return self._generate_witness_native(external_values)
        lo = np.zeros(self.num_vars, dtype=np.uint32)
        hi = np.zeros(self.num_vars, dtype=np.uint32)
        ext = np.asarray(external_values, dtype=np.uint64)
        assert ext.shape[0] == self.external_vars.shape[0], \
            f"need {self.external_vars.shape[0]} external values, got {ext.shape[0]}"
        lo[self.external_vars] = (ext & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi[self.external_vars] = (ext >> np.uint64(32)).astype(np.uint32)
        G = _GNP
        timer = open_timer()
        spent = [0, 0]  # ns in arithmetic segments, in hint segments
        last = time.perf_counter_ns() if timer else 0
        for bt in self.gen_batches:
            av = (lo[bt.a], hi[bt.a])
            if bt.op == GEN_CONST:
                r = (
                    (bt.const & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                    (bt.const >> np.uint64(32)).astype(np.uint32),
                )
            elif bt.op == GEN_ADD:
                r = G.add(av, (lo[bt.b], hi[bt.b]))
            elif bt.op == GEN_SUB:
                r = G.sub(av, (lo[bt.b], hi[bt.b]))
            elif bt.op == GEN_MUL:
                r = G.mul(av, (lo[bt.b], hi[bt.b]))
            elif bt.op == GEN_MULADDC:
                c = ((bt.const & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (bt.const >> np.uint64(32)).astype(np.uint32))
                r = G.add(G.mul(av, c), (lo[bt.b], hi[bt.b]))
            elif bt.op == GEN_MULMULC:
                c = ((bt.const & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (bt.const >> np.uint64(32)).astype(np.uint32))
                r = G.mul(G.mul(av, (lo[bt.b], hi[bt.b])), c)
            elif bt.op == GEN_INV:
                # 0 -> 0 so is_zero hints work; nonzero -> true inverse
                inv = G.inv(av)
                z = G.is_zero(av)
                r = (np.where(z, np.uint32(0), inv[0]),
                     np.where(z, np.uint32(0), inv[1]))
            elif bt.op == GEN_BIT:
                v64 = G.to_u64(av)
                bit = (v64 >> bt.const) & np.uint64(1)
                r = (bit.astype(np.uint32), np.zeros_like(bit, dtype=np.uint32))
            elif bt.op == GEN_HINT_OUT:
                # run each distinct hint once, scatter all its outputs
                out_lo = np.zeros(bt.out.shape[0], dtype=np.uint32)
                out_hi = np.zeros(bt.out.shape[0], dtype=np.uint32)
                done = {}
                for pos in range(bt.out.shape[0]):
                    hid = int(bt.a[pos])
                    j = int(bt.const[pos])
                    if hid not in done:
                        h = self.hints[hid]
                        ivals = [int(G.to_u64((lo[i], hi[i]))) for i in h.inputs]
                        done[hid] = [v % P for v in h.fn(ivals)]
                    v = done[hid][j]
                    out_lo[pos] = v & 0xFFFFFFFF
                    out_hi[pos] = v >> 32
                r = (out_lo, out_hi)
            else:
                raise AssertionError(f"bad generator opcode {bt.op}")
            lo[bt.out] = r[0]
            hi[bt.out] = r[1]
            if timer:
                now = time.perf_counter_ns()
                spent[bt.op == GEN_HINT_OUT] += now - last
                last = now
        if timer:
            _count_fill(timer, spent)
        return G.to_u64((lo, hi))

    def _generate_witness_native(self, external_values: np.ndarray) -> np.ndarray:
        from .. import native
        gp = self.gen_program
        vals = np.zeros(self.num_vars, dtype=np.uint64)
        ext = np.asarray(external_values, dtype=np.uint64)
        assert ext.shape[0] == self.external_vars.shape[0], \
            f"need {self.external_vars.shape[0]} external values, got {ext.shape[0]}"
        vals[self.external_vars] = ext
        timer = open_timer()
        spent = [0, 0]  # ns in C segments, in hint segments
        last = time.perf_counter_ns() if timer else 0
        hint_runs = iter(gp.hint_runs)
        for (start, end, is_hint) in gp.segments:
            if not is_hint:
                native.run_ops(start, end, gp.order, gp.op, gp.out, gp.a,
                               gp.b, gp.const, vals)
            else:
                for hid, ins, outs, places in next(hint_runs):
                    res = self.hints[hid].fn(vals[ins].tolist())
                    vals[outs] = [res[j] % P for j in places]
            if timer:
                now = time.perf_counter_ns()
                spent[is_hint] += now - last
                last = now
        if timer:
            _count_fill(timer, spent)
        return vals

    def wire_values(self, vals: np.ndarray) -> np.ndarray:
        """(NUM_WIRES, n) uint64 wire matrix from the variable value vector."""
        return vals[self.wire_vars]

    def multiplicities(self, wires: np.ndarray) -> np.ndarray:
        """(n,) uint64 lookup multiplicity column: m[t] = number of lookup
        slots whose value is t.  Raises if any looked-up value is out of
        table range (the witness cannot satisfy the LogUp argument)."""
        m = np.zeros(self.n, dtype=np.uint64)
        if self.lookup_bits == 0 or self.lookup_rows is None or \
                self.lookup_rows.size == 0:
            return m
        vals = wires[:, self.lookup_rows].reshape(-1)
        if vals.size and int(vals.max()) >= (1 << self.lookup_bits):
            bad = int(vals.max())
            raise AssertionError(
                f"lookup value {bad} out of range [0, 2^{self.lookup_bits})")
        counts = np.bincount(vals.astype(np.int64), minlength=self.n)
        return counts.astype(np.uint64)

    # ---- debugging ---------------------------------------------------------

    def check_constraints(self, vals: np.ndarray) -> Optional[int]:
        """Return the first violated row index, or None if satisfied
        (including PI rows against registered public input values and
        lookup range bounds)."""
        w = self.wire_values(vals)
        pi = np.zeros(self.n, dtype=np.uint64)
        for j, pv in enumerate(self.public_input_vars):
            pi[j] = vals[pv]
        try:
            from ..native import check_rows
            bad_row = check_rows(self.selectors, w, pi, NUM_PAIRS)
        except ImportError:  # pragma: no cover
            bad_row = None
        if bad_row is None:
            w = w.astype(object)
            s = self.selectors.astype(object)
            acc = np.zeros(self.n, dtype=object)
            for j in range(NUM_PAIRS):
                acc = (acc + s[SEL_QM0 + j] * w[2 * j] % P * w[2 * j + 1]) % P
            for i in range(NUM_WIRES):
                acc = (acc + s[SEL_Q0 + i] * w[i]) % P
            acc = (acc + s[SEL_QC]) % P
            acc = (acc - pi.astype(object)) % P
            bad = np.nonzero(acc != 0)[0]
            bad_row = int(bad[0]) if bad.size else -1
        if bad_row >= 0:
            return bad_row
        if self.lookup_bits and self.lookup_rows is not None and \
                self.lookup_rows.size:
            lv = self.wire_values(vals)[:, self.lookup_rows]
            over = np.nonzero(lv.max(axis=0) >= (1 << self.lookup_bits))[0]
            if over.size:
                return int(self.lookup_rows[over[0]])
        return None

    def public_values(self, vals: np.ndarray) -> List[int]:
        return [int(vals[v]) for v in self.public_input_vars]


def _count_fill(timer, spent_ns) -> None:
    """A witness fill's counters (``CompiledCircuit.generate_witness``)."""
    timer.count("fill_native_s", spent_ns[0] * 1e-9)
    timer.count("fill_hint_s", spent_ns[1] * 1e-9)


def _schedule_generators(builder: CircuitBuilder):
    """Topological level scheduling.  Returns (gen_batches, gen_program):
    the batched-numpy fallback plan and the flat native plan.  The level
    fixpoint runs in the native core (native/witnesscore.c gl_schedule)
    when available, mirroring the pure-Python loop below."""
    ops = builder.gen_ops
    n_ops = len(ops)
    cols = list(zip(*ops)) if ops else [()] * 5
    op_arr = np.fromiter(cols[0], dtype=np.int32, count=n_ops)
    out_arr = np.fromiter(cols[1], dtype=np.int64, count=n_ops)
    a_arr = np.fromiter(cols[2], dtype=np.int64, count=n_ops)
    b_arr = np.fromiter(cols[3], dtype=np.int64, count=n_ops)
    cst_arr = np.fromiter((c % (1 << 64) for c in cols[4]),
                          dtype=np.uint64, count=n_ops)
    hint_in_off = np.zeros(len(builder.hints) + 1, dtype=np.int64)
    for i, h in enumerate(builder.hints):
        hint_in_off[i + 1] = hint_in_off[i] + len(h.inputs)
    hint_in = np.fromiter((v for h in builder.hints for v in h.inputs),
                          dtype=np.int64, count=int(hint_in_off[-1]))

    level = None
    try:
        from .. import native
        level = native.schedule_levels(op_arr, out_arr, a_arr, b_arr,
                                       hint_in_off, hint_in,
                                       builder.num_vars)
    except ImportError:  # pragma: no cover
        level = None
    if level is None:
        level = np.zeros(builder.num_vars, dtype=np.int64)
        uses_a = {GEN_ADD, GEN_SUB, GEN_MUL, GEN_MULADDC, GEN_INV, GEN_BIT,
                  GEN_MULMULC}
        uses_b = {GEN_ADD, GEN_SUB, GEN_MUL, GEN_MULADDC, GEN_MULMULC}
        # ops are appended in creation order but inputs may be created
        # later (e.g. lazily materialized constants): iterate to fixpoint.
        changed = True
        guard = 0
        while changed:
            changed = False
            guard += 1
            assert guard <= len(ops) + 2, "generator dependency cycle"
            for code, out, a, b, _ in ops:
                lv = 0
                if code in uses_a:
                    lv = max(lv, level[a] + 1)
                if code in uses_b:
                    lv = max(lv, level[b] + 1)
                if code == GEN_HINT_OUT:
                    h = builder.hints[a]
                    for i in h.inputs:
                        lv = max(lv, level[i] + 1)
                if code in (GEN_CONST, GEN_EXTERNAL):
                    lv = 0
                if lv != level[out]:
                    level[out] = lv
                    changed = True

    op_levels = level[out_arr]
    # fallback plan: per-(level, opcode) numpy batches
    nonext = op_arr != GEN_EXTERNAL
    idx = np.nonzero(nonext)[0]
    sort_key = np.lexsort((op_arr[idx], op_levels[idx]))
    sorted_idx = idx[sort_key]
    batches = []
    if sorted_idx.size:
        keys = np.stack([op_levels[sorted_idx], op_arr[sorted_idx]])
        bounds = np.nonzero((np.diff(keys[0]) != 0) |
                            (np.diff(keys[1]) != 0))[0] + 1
        starts = np.concatenate([[0], bounds, [sorted_idx.size]])
        for s, e in zip(starts[:-1], starts[1:]):
            grp = sorted_idx[s:e]
            batches.append(GenBatch(
                op=int(op_arr[grp[0]]), out=out_arr[grp], a=a_arr[grp],
                b=b_arr[grp], const=cst_arr[grp]))

    # native plan: level-sorted order (hints last within a level — they
    # only depend on lower levels, and grouping them minimizes the number
    # of C/python segment switches), segmented at hint runs
    hint_flag = (op_arr == GEN_HINT_OUT).astype(np.int8)
    order = idx[np.lexsort((hint_flag[idx], op_levels[idx]))]
    is_hint = op_arr[order] == GEN_HINT_OUT
    segments = []
    if order.size:
        flips = np.nonzero(np.diff(is_hint))[0] + 1
        starts = np.concatenate([[0], flips, [order.size]])
        for s, e in zip(starts[:-1], starts[1:]):
            segments.append((int(s), int(e), bool(is_hint[s])))
    hint_runs = []
    for s, e, hint_seg in segments:
        if not hint_seg:
            continue
        run: dict = {}
        seg = order[s:e]
        for h, j, o in zip(a_arr[seg].tolist(), cst_arr[seg].tolist(),
                           out_arr[seg].tolist()):
            outs, places = run.setdefault(h, ([], []))
            outs.append(o)
            places.append(j)
        hint_runs.append([
            (h, np.asarray(builder.hints[h].inputs, dtype=np.int64),
             np.asarray(outs, dtype=np.int64), places)
            for h, (outs, places) in run.items()])
    program = GenProgram(op=op_arr, out=out_arr, a=a_arr, b=b_arr,
                         const=cst_arr, order=order, segments=segments,
                         hint_runs=hint_runs)
    return batches, program


def compile_circuit(builder: CircuitBuilder) -> CompiledCircuit:
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
    rows = builder.rows
    gate = slice(num_pub, num_pub + num_gate_rows)

    def column_block(values, dtype, width):
        return np.fromiter(values, dtype=dtype, count=num_gate_rows * width) \
            .reshape(num_gate_rows, width).T

    selectors[SEL_QM0:SEL_QM0 + NUM_PAIRS, gate] = column_block(
        chain.from_iterable(row.qm for row in rows), np.uint64, NUM_PAIRS)
    selectors[SEL_Q0:SEL_Q0 + NUM_WIRES, gate] = column_block(
        chain.from_iterable(row.q for row in rows), np.uint64, NUM_WIRES)
    selectors[SEL_QC, gate] = column_block(
        (row.qc for row in rows), np.uint64, 1)[0]
    wire_vars[:, gate] = column_block(
        (0 if w is None else w for row in rows for w in row.wires),
        np.int64, NUM_WIRES)

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

    # -- sigma ---------------------------------------------------------------
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

    gen_batches, gen_program = _schedule_generators(builder)
    # in creation order
    external_vars = gen_program.out[gen_program.op == GEN_EXTERNAL]
    return CompiledCircuit(
        n=n, log_n=log_n, num_vars=builder.num_vars,
        selectors=selectors, wire_vars=wire_vars, sigma=sigma,
        k_shifts=k_shifts, gen_batches=gen_batches,
        hints=list(builder.hints),
        external_vars=external_vars,
        public_input_vars=np.array(builder.public_inputs, dtype=np.int64),
        num_public_inputs=num_pub,
        lookup_bits=builder.lookup_bits if num_lookup_rows else 0,
        lookup_rows=lookup_rows, table=table, gen_program=gen_program)
