"""Big-unsigned-integer gadgets over 16-bit limbs (LSB first).

Capability analog of the reference's vendored BigUint stack (SURVEY.md
C19-C20: biguint/biguint.rs add/sub/mul/cmp/div_rem).  Design differs by
construction: the reference drives custom U32 gates (mul_add/add_many/
subtraction with per-gate 2-bit-limb range constraints, C14-C18); here
limb bounds come from the LogUp 16-bit lookup table (circuit/builder.py
range_check) and multi-limb identities are enforced as ONE balanced
column identity with hinted carry limbs:

    sum_c 2^(16c) * lhs_col_c  ==  sum_c 2^(16c) * rhs_col_c

checked column-by-column with offset-encoded signed carries, each row a
wide dot-product gate.  Every per-column equation is an integer equality
(all term ranges < 2^49 << p), so the telescoped sum is an exact integer
identity — the same value-certificate style the reference uses for div_rem
(BigUintDivRemGenerator, biguint.rs:316-360) at a fraction of the rows.

When the builder has no lookup table (small circuits), range_check falls
back to bit decomposition and everything still works, just wider.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..circuit.builder import CircuitBuilder, NUM_PAIRS, NUM_WIRES
from ..field.gl import P

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1

# offset encoding for signed carries: carry = c' - CARRY_OFF with
# c' = c_lo + 2^16 c_hi, both 16-bit lookups -> carry in [-2^31, 2^33)
CARRY_OFF = 1 << 31


@dataclass
class BigUintTarget:
    """Normalized big integer: limbs[i] in [0, 2^16), value = sum limb_i b^i.
    Limbs are range-checked at construction."""
    limbs: List[int]  # circuit vars, LSB first

    def num_limbs(self):
        return len(self.limbs)


# a column term is ("l", coeff, var) or ("m", coeff, var_a, var_b); coeff
# must be a small positive integer (the int-range soundness argument needs
# column values < ~2^40)
Term = Tuple


def limbs_of_int(v: int, n_limbs: int) -> List[int]:
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)]


def big_constant(b: CircuitBuilder, v: int, n_limbs: int) -> BigUintTarget:
    return BigUintTarget([b.constant(x) for x in limbs_of_int(v, n_limbs)])


def big_from_vars(b: CircuitBuilder, limb_vars: Sequence[int],
                  range_check: bool = True) -> BigUintTarget:
    if range_check:
        for v in limb_vars:
            b.range_check(v, LIMB_BITS)
    return BigUintTarget(list(limb_vars))


def big_from_bytes_be(b: CircuitBuilder, byte_vars: Sequence[int],
                      range_check_bytes: bool = True) -> BigUintTarget:
    """32 big-endian byte vars -> 16 limbs (the ECDSA input conversion,
    ecdsa_secp256k1_translator.rs:95-121 does bytes -> u32 limbs)."""
    if range_check_bytes:
        for v in byte_vars:
            b.range_check(v, 8)
    le = list(reversed(list(byte_vars)))
    limbs = [b.lincomb([(1, le[2 * i]), (256, le[2 * i + 1])])
             for i in range(len(le) // 2)]
    return BigUintTarget(limbs)


def big_value_hint(vals: List[int], n_limbs: int) -> int:
    return sum(v << (LIMB_BITS * i) for i, v in enumerate(vals[:n_limbs]))


def _col_value(col, vals):
    s = 0
    for t in col:
        if t[0] == "l":
            s += t[1] * vals[t[2]]
        else:
            s += t[1] * vals[t[2]] * vals[t[3]]
    return s


def _reduce_col(b: CircuitBuilder, col) -> Tuple[list, list]:
    """Fold a column's terms until they fit one identity row alongside the
    4 carry wires: returns (mul_terms, lin_terms) with
    2*len(mul) + len(lin) <= NUM_WIRES - 4."""
    muls = [(c, x, y) for (k, c, x, y) in
            [(t[0], t[1], t[2], t[3] if t[0] == "m" else None) for t in col]
            if k == "m"]
    lins = [(t[1], t[2]) for t in col if t[0] == "l"]
    budget = NUM_WIRES - 4
    max_pairs = (NUM_WIRES - 1) // 2  # pairs + out var must fit one row
    while 2 * len(muls) + len(lins) > budget:
        nm = min(len(muls), max_pairs)
        room = NUM_WIRES - 2 * nm - 1
        nl = min(len(lins), max(0, room))
        acc = b.new_derived()
        b.dot_row(muls[:nm], lins[:nl], 0, acc)
        muls = muls[nm:]
        lins = [(1, acc)] + lins[nl:]
    return muls, lins


def assert_col_identity(b: CircuitBuilder, lhs_cols: List[list],
                        rhs_cols: List[list]):
    """Assert sum_c 2^(16c) lhs_col_c == sum_c 2^(16c) rhs_col_c via hinted
    offset carries.  Column values must stay below ~2^40 (callers: at most
    ~16 products of 16-bit limbs plus small-coefficient linear terms)."""
    ncols = max(len(lhs_cols), len(rhs_cols))
    lhs_cols = list(lhs_cols) + [[] for _ in range(ncols - len(lhs_cols))]
    rhs_cols = list(rhs_cols) + [[] for _ in range(ncols - len(rhs_cols))]

    # one hint computes every carry limb pair from all referenced vars
    var_ix: dict = {}

    def ix(v):
        if v not in var_ix:
            var_ix[v] = len(var_ix)
        return var_ix[v]

    sym = []
    for lc, rc in zip(lhs_cols, rhs_cols):
        sl = [("l", t[1], ix(t[2])) if t[0] == "l"
              else ("m", t[1], ix(t[2]), ix(t[3])) for t in lc]
        sr = [("l", t[1], ix(t[2])) if t[0] == "l"
              else ("m", t[1], ix(t[2]), ix(t[3])) for t in rc]
        sym.append((sl, sr))
    inputs = list(var_ix.keys())

    def fn(vals):
        outs = []
        carry = 0
        for (sl, sr) in sym[:-1]:
            diff = _col_value(sl, vals) - _col_value(sr, vals) + carry
            assert diff % LIMB_BASE == 0, "column identity does not balance"
            carry = diff >> LIMB_BITS
            enc = carry + CARRY_OFF
            assert 0 <= enc < (1 << 32), "carry out of encodable range"
            outs.extend([enc & LIMB_MASK, enc >> LIMB_BITS])
        return outs

    carries = b.hint(inputs, 2 * (ncols - 1), fn) if ncols > 1 else []
    for v in carries:
        b.range_check(v, LIMB_BITS)

    for c in range(ncols):
        # lhs_col - rhs_col + carry_in - 2^16 * carry_out == 0, with
        # carry = (c_lo + 2^16 c_hi) - CARRY_OFF
        muls_l, lins_l = _reduce_col(b, lhs_cols[c])
        muls_r, lins_r = _reduce_col(b, rhs_cols[c])
        muls = muls_l + [((P - m0) % P, x, y) for m0, x, y in muls_r]
        lins = lins_l + [((P - d) % P, v) for d, v in lins_r]
        const = 0
        if c > 0:
            lins.append((1, carries[2 * (c - 1)]))
            lins.append((LIMB_BASE, carries[2 * (c - 1) + 1]))
            const -= CARRY_OFF
        if c < ncols - 1:
            lins.append((P - LIMB_BASE, carries[2 * c]))
            lins.append(((P - (LIMB_BASE * LIMB_BASE)) % P,
                         carries[2 * c + 1]))
            const += CARRY_OFF * LIMB_BASE
        # may exceed one row after merging both sides: fold again
        max_pairs = (NUM_WIRES - 1) // 2
        while 2 * len(muls) + len(lins) > NUM_WIRES or len(muls) > NUM_PAIRS:
            nm = min(len(muls), max_pairs)
            room = NUM_WIRES - 2 * nm - 1
            nl = min(len(lins), max(0, room))
            acc = b.new_derived()
            b.dot_row(muls[:nm], lins[:nl], 0, acc)
            muls = muls[nm:]
            lins = [(1, acc)] + lins[nl:]
        b.dot_row(muls, lins, const, None)


def _mul_cols(x: BigUintTarget, y: BigUintTarget) -> List[list]:
    cols = [[] for _ in range(x.num_limbs() + y.num_limbs() - 1)]
    for i, xi in enumerate(x.limbs):
        for j, yj in enumerate(y.limbs):
            cols[i + j].append(("m", 1, xi, yj))
    return cols


def _mul_const_cols(c_limbs: List[int], y: BigUintTarget) -> List[list]:
    """Columns of (constant c) * y as linear terms."""
    cols = [[] for _ in range(len(c_limbs) + y.num_limbs() - 1)]
    for i, ci in enumerate(c_limbs):
        if ci == 0:
            continue
        for j, yj in enumerate(y.limbs):
            cols[i + j].append(("l", ci, yj))
    return cols


def _limb_cols(x: BigUintTarget) -> List[list]:
    return [[("l", 1, v)] for v in x.limbs]


def _balance(b: CircuitBuilder, cols: List[list], out_limbs: int,
             hint_inputs_extra=()) -> BigUintTarget:
    """Produce normalized limbs out[c] with
    sum 2^(16c) col_c == sum 2^(16c) out_c (hint + column identity)."""
    var_ix: dict = {}

    def ix(v):
        if v not in var_ix:
            var_ix[v] = len(var_ix)
        return var_ix[v]

    sym = [[("l", t[1], ix(t[2])) if t[0] == "l"
            else ("m", t[1], ix(t[2]), ix(t[3])) for t in col]
           for col in cols]
    inputs = list(var_ix.keys())

    def fn(vals):
        total = 0
        for c, col in enumerate(sym):
            total += _col_value(col, vals) << (LIMB_BITS * c)
        assert total < (1 << (LIMB_BITS * out_limbs)), \
            "balance output width too small"
        return limbs_of_int(total, out_limbs)

    outs = b.hint(inputs, out_limbs, fn)
    out = big_from_vars(b, outs)
    assert_col_identity(b, cols, _limb_cols(out))
    return out


def big_add(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> BigUintTarget:
    n = max(x.num_limbs(), y.num_limbs())
    cols = [[] for _ in range(n)]
    for i, xi in enumerate(x.limbs):
        cols[i].append(("l", 1, xi))
    for i, yi in enumerate(y.limbs):
        cols[i].append(("l", 1, yi))
    return _balance(b, cols, n + 1)


def big_mul(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> BigUintTarget:
    """Schoolbook product (biguint.rs:183-207 analog) as one balanced
    column identity."""
    return _balance(b, _mul_cols(x, y), x.num_limbs() + y.num_limbs())


def big_assert_eq(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget):
    """Limb-wise equality, 3 limbs per row: sum of (x_i - y_i) 2^(16i)
    over a 48-bit group is < p in magnitude, so the field equation forces
    every limb difference to zero."""
    n = max(x.num_limbs(), y.num_limbs())
    for s in range(0, n, 3):
        terms = []
        for i in range(s, min(s + 3, n)):
            w = 1 << (LIMB_BITS * (i - s))
            if i < x.num_limbs():
                terms.append((w, x.limbs[i]))
            if i < y.num_limbs():
                terms.append(((P - w) % P, y.limbs[i]))
        if terms:
            b.assert_lincomb_zero(terms)


def big_assert_le(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget):
    """x <= y: hint d = y - x (range-checked limbs), assert x + d == y as
    a column identity (role of the reference's ComparisonGate chain,
    C18/C20)."""
    n = max(x.num_limbs(), y.num_limbs())

    def fn(vals):
        xv = big_value_hint(vals[:x.num_limbs()], x.num_limbs())
        yv = big_value_hint(vals[x.num_limbs():], y.num_limbs())
        return limbs_of_int(max(0, yv - xv), n)

    d_vars = b.hint(list(x.limbs) + list(y.limbs), n, fn)
    d = big_from_vars(b, d_vars)
    lhs = [[] for _ in range(n)]
    for i, xi in enumerate(x.limbs):
        lhs[i].append(("l", 1, xi))
    for i, di in enumerate(d.limbs):
        lhs[i].append(("l", 1, di))
    assert_col_identity(b, lhs, _limb_cols(y))


def big_lt_bool(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> int:
    """Boolean var: x < y.  Hint lt and d = (lt ? y-x-1 : x-y); then
    smaller + d + lt == bigger as one column identity over selected
    limbs."""
    n = max(x.num_limbs(), y.num_limbs())

    def pad(t):
        return t.limbs + [b.zero] * (n - t.num_limbs())

    xl, yl = pad(x), pad(y)

    def fn(vals):
        xv = big_value_hint(vals[:n], n)
        yv = big_value_hint(vals[n:], n)
        lt = 1 if xv < yv else 0
        d = (yv - xv - 1) if lt else (xv - yv)
        return [lt] + limbs_of_int(d, n)

    outs = b.hint(xl + yl, 1 + n, fn)
    lt = outs[0]
    b.assert_bool(lt)
    d = big_from_vars(b, outs[1:])
    small = b.select_vec(lt, xl, yl)
    big = b.select_vec(lt, yl, xl)
    lhs = [[] for _ in range(n)]
    lhs[0].append(("l", 1, lt))
    for i in range(n):
        lhs[i].append(("l", 1, small[i]))
        lhs[i].append(("l", 1, d.limbs[i]))
    assert_col_identity(b, lhs, [[("l", 1, v)] for v in big])
    return lt


def big_le_bool(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> int:
    """Boolean var: x <= y  ==  not (y < x)."""
    return b.bit_not(big_lt_bool(b, y, x))
