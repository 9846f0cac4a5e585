"""secp256k1 nonnative field + curve gadgets over the 16-bit-limb BigUint.

Capability analog of the reference's vendored nonnative/curve stack
(SURVEY.md C21 nonnative.rs, C22 curve.rs): every modular operation is a
host hint plus an algebraic certificate (x*y = k*q + r — the same
overflow-quotient pattern as nonnative.rs:312-341), and curve arithmetic is
affine with hinted slopes (3 modular mults per add, 4 per double, no
in-circuit inversions).  Each certificate is ONE balanced column identity
(ops/bigint.py assert_col_identity), so a 256-bit modular multiply costs
~100 rows instead of thousands.

Residues are kept WEAKLY normalized: r is range-checked to 16 limbs
(< 2^256) but not canonically reduced below the modulus — every
certificate checks congruence, which composes soundly; hints always emit
canonical values so honest proving is complete.  (The reference's
nonnative gadgets carry the same property: reduction happens lazily.)
Canonicity is enforced only where an integer comparison is exposed
(ECDSA's r <= R.x output, ops/ecdsa.py).

Like the reference's gadgets (curve.rs:181-197 "add assuming p != q"),
point addition is INCOMPLETE: honest witnesses never hit x1 == x2 thanks to
the fixed blinding offset in scalar_mul (the reference seeds with hardcoded
random points, glv.rs:310-384 — same technique, our own constants).

Frozen for the benchmark's reference: a copy of the port's
``tpu_acir_prover_torch/ops/secp256k1.py`` as it stood at commit c8d5fef,
its relative imports resolving inside ``prover_bench/frozen/``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..circuit.builder import CircuitBuilder
from .bigint import (BigUintTarget, LIMB_BITS, assert_col_identity, big_add,
                     big_assert_eq, big_assert_le, big_constant,
                     big_from_vars, big_mul, big_value_hint, limbs_of_int,
                     _limb_cols, _mul_cols, _mul_const_cols)

NLIMBS = 16  # 256 bits

# secp256k1 parameters
Q = 2**256 - 2**32 - 977                      # base field
N_SCALAR = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


@dataclass
class NNTarget:
    """Nonnative field element mod `modulus`: a 16-limb BigUint congruent
    to the value (weakly normalized, < 2^256)."""
    big: BigUintTarget
    modulus: int


@dataclass
class PointTarget:
    x: NNTarget
    y: NNTarget


def nn_constant(b: CircuitBuilder, v: int, modulus: int = Q) -> NNTarget:
    return NNTarget(big_constant(b, v % modulus, NLIMBS), modulus)


def _rhs_km_r(b: CircuitBuilder, k: BigUintTarget, r, modulus: int,
              const: int = 0) -> List[list]:
    """Columns of k*modulus + r (+ const), modulus constant, r a
    BigUintTarget or None."""
    m_limbs = limbs_of_int(modulus, NLIMBS)
    cols = _mul_const_cols(m_limbs, k)
    if r is not None:
        for i, ri in enumerate(r.limbs):
            while len(cols) <= i:
                cols.append([])
            cols[i].append(("l", 1, ri))
    if const:
        for i, cv in enumerate(limbs_of_int(const, NLIMBS)):
            if cv:
                while len(cols) <= i:
                    cols.append([])
                cols[i].append(("l", cv, b.one))
    return cols


def nn_from_big(b: CircuitBuilder, big: BigUintTarget, modulus: int = Q,
                reduce: bool = True) -> NNTarget:
    """Wrap a BigUint as a field element; certificate big = k*m + r
    (hint+check, nonnative.rs reduce analog)."""
    if not reduce and big.num_limbs() == NLIMBS:
        return NNTarget(big, modulus)
    m = modulus
    nk = max(1, big.num_limbs() - NLIMBS + 1)

    def fn(vals):
        v = big_value_hint(vals, big.num_limbs())
        return limbs_of_int(v // m, nk) + limbs_of_int(v % m, NLIMBS)

    outs = b.hint(list(big.limbs), nk + NLIMBS, fn)
    k = big_from_vars(b, outs[:nk])
    r = big_from_vars(b, outs[nk:])
    assert_col_identity(b, _limb_cols(big), _rhs_km_r(b, k, r, m))
    return NNTarget(r, m)


def nn_mul(b: CircuitBuilder, x: NNTarget, y: NNTarget) -> NNTarget:
    """r = x*y mod m via certificate x*y = k*m + r (nonnative.rs:312-341),
    one balanced column identity."""
    m = x.modulus
    assert y.modulus == m

    def fn(vals):
        xv = big_value_hint(vals[:NLIMBS], NLIMBS)
        yv = big_value_hint(vals[NLIMBS:], NLIMBS)
        p = xv * yv
        return limbs_of_int(p // m, NLIMBS + 1) + limbs_of_int(p % m, NLIMBS)

    outs = b.hint(list(x.big.limbs) + list(y.big.limbs), 2 * NLIMBS + 1, fn)
    k = big_from_vars(b, outs[:NLIMBS + 1])
    r = big_from_vars(b, outs[NLIMBS + 1:])
    assert_col_identity(b, _mul_cols(x.big, y.big), _rhs_km_r(b, k, r, m))
    return NNTarget(r, m)


def nn_mul_const(b: CircuitBuilder, x: NNTarget, c: int) -> NNTarget:
    """r = c*x mod m: certificate c*x = k*m + r with constant c."""
    m = x.modulus
    c %= m

    def fn(vals):
        xv = big_value_hint(vals, NLIMBS)
        p = c * xv
        return limbs_of_int(p // m, NLIMBS + 1) + limbs_of_int(p % m, NLIMBS)

    outs = b.hint(list(x.big.limbs), 2 * NLIMBS + 1, fn)
    k = big_from_vars(b, outs[:NLIMBS + 1])
    r = big_from_vars(b, outs[NLIMBS + 1:])
    assert_col_identity(b, _mul_const_cols(limbs_of_int(c, NLIMBS), x.big),
                        _rhs_km_r(b, k, r, m))
    return NNTarget(r, m)


def _linear_mod(b: CircuitBuilder, terms: List[Tuple[int, NNTarget]],
                modulus: int) -> NNTarget:
    """r = sum(sign_i * x_i) mod m for sign in {+1,-1}: certificate
    sum(pos) + |neg|*m = sum(neg) + k*m + r with small k."""
    pos = [x for s, x in terms if s > 0]
    neg = [x for s, x in terms if s < 0]
    m = modulus

    def fn(vals):
        vs = [big_value_hint(vals[i * NLIMBS:(i + 1) * NLIMBS], NLIMBS)
              for i in range(len(terms))]
        total = len(neg) * m
        for (s, _), v in zip(terms, vs):
            total += s * v
        r = total % m
        k = (total - r) // m
        assert k >= 0
        return [k] + limbs_of_int(r, NLIMBS)

    inp = []
    for _, x in terms:
        inp.extend(x.big.limbs)
    outs = b.hint(inp, 1 + NLIMBS, fn)
    kv = outs[0]
    # k < #terms + |neg| (tiny); a 16-bit bound is plenty
    b.range_check(kv, LIMB_BITS)
    k = BigUintTarget([kv])
    r = big_from_vars(b, outs[1:])
    lhs = [[] for _ in range(NLIMBS)]
    for i, cv in enumerate(limbs_of_int(len(neg) * m, NLIMBS + 1)):
        if cv:
            while len(lhs) <= i:
                lhs.append([])
            lhs[i].append(("l", cv, b.one))
    for x in pos:
        for i, xi in enumerate(x.big.limbs):
            lhs[i].append(("l", 1, xi))
    rhs = _rhs_km_r(b, k, r, m)
    for x in neg:
        for i, xi in enumerate(x.big.limbs):
            rhs[i].append(("l", 1, xi))
    assert_col_identity(b, lhs, rhs)
    return NNTarget(r, m)


def nn_add(b, x: NNTarget, y: NNTarget) -> NNTarget:
    return _linear_mod(b, [(1, x), (1, y)], x.modulus)


def nn_sub(b, x: NNTarget, y: NNTarget) -> NNTarget:
    return _linear_mod(b, [(1, x), (-1, y)], x.modulus)


def nn_inv(b: CircuitBuilder, x: NNTarget) -> NNTarget:
    """r = x^-1 mod m: certificate x*r = k*m + 1 (nonnative.rs:365-389)."""
    m = x.modulus

    def fn(vals):
        xv = big_value_hint(vals, NLIMBS) % m
        rv = pow(xv, -1, m) if xv else 0
        p = big_value_hint(vals, NLIMBS) * rv
        return limbs_of_int(rv, NLIMBS) + limbs_of_int(p // m, NLIMBS + 1)

    outs = b.hint(list(x.big.limbs), NLIMBS + NLIMBS + 1, fn)
    r = big_from_vars(b, outs[:NLIMBS])
    k = big_from_vars(b, outs[NLIMBS:])
    assert_col_identity(b, _mul_cols(x.big, r),
                        _rhs_km_r(b, k, None, m, const=1))
    return NNTarget(r, m)


def nn_select(b: CircuitBuilder, bit: int, x: NNTarget, y: NNTarget) -> NNTarget:
    limbs = b.select_vec(bit, x.big.limbs, y.big.limbs)
    return NNTarget(BigUintTarget(limbs), x.modulus)


def nn_assert_canonical(b: CircuitBuilder, x: NNTarget):
    """x.big <= m-1: needed only where integer comparisons are exposed."""
    big_assert_le(b, x.big, big_constant(b, x.modulus - 1, NLIMBS))


def point_select(b, bit: int, p1: PointTarget, p2: PointTarget) -> PointTarget:
    return PointTarget(nn_select(b, bit, p1.x, p2.x),
                       nn_select(b, bit, p1.y, p2.y))


def _onehot(b: CircuitBuilder, bits: List[int]) -> List[int]:
    """2^len(bits) indicator vars from boolean-constrained bits (LSB-first
    index encoding) — the wide-gate equivalent of the reference's
    random_access index decomposition (glv.rs:339-384)."""
    oh = [b.one]
    for bit in bits:
        t = [b.mul(o, bit) for o in oh]
        oh = [b.sub(o, x) for o, x in zip(oh, t)] + t
    return oh


def _mux_points(b: CircuitBuilder, oh: List[int],
                pts: List[PointTarget]) -> PointTarget:
    """sum_j oh_j * pts_j per limb (one-hot weighted dot rows).  Selected
    limbs inherit the table limbs' range bounds (oh is provably one-hot),
    so no re-range-checking is needed."""
    def mux_limbs(limbs_of):
        out = []
        for li in range(NLIMBS):
            terms = [(1, oh[j], limbs_of(j)[li]) for j in range(len(pts))]
            acc = None
            while terms:
                chunk = terms[:7]
                terms = terms[7:]
                lin = [(1, acc)] if acc is not None else []
                nv = b.new_derived()
                b.dot_row(chunk, lin, 0, nv)
                acc = nv
            out.append(acc)
        return out

    m = pts[0].x.modulus
    return PointTarget(
        NNTarget(BigUintTarget(mux_limbs(lambda j: pts[j].x.big.limbs)), m),
        NNTarget(BigUintTarget(mux_limbs(lambda j: pts[j].y.big.limbs)), m))


def _mux_const_points(b: CircuitBuilder, oh: List[int],
                      pts_xy: List[Tuple[int, int]]) -> PointTarget:
    """sum_j oh_j * (constant point)_j: pure linear rows per limb."""
    def mux_limbs(coord):
        out = []
        for li in range(NLIMBS):
            terms = []
            for j, xy in enumerate(pts_xy):
                cv = (xy[coord] >> (LIMB_BITS * li)) & ((1 << LIMB_BITS) - 1)
                if cv:
                    terms.append((cv, oh[j]))
            out.append(b.lincomb(terms) if terms else b.zero)
        return out

    return PointTarget(NNTarget(BigUintTarget(mux_limbs(0)), Q),
                       NNTarget(BigUintTarget(mux_limbs(1)), Q))


def point_constant(b, xy: Tuple[int, int]) -> PointTarget:
    return PointTarget(nn_constant(b, xy[0]), nn_constant(b, xy[1]))


def point_add(b: CircuitBuilder, p: PointTarget, q: PointTarget) -> PointTarget:
    """Affine add assuming p != +-q (curve.rs:181-197 semantics), hinted
    slope: s*(x2-x1) == y2-y1; x3 = s^2-x1-x2; y3 = s*(x1-x3)-y1."""
    m = p.x.modulus

    def slope_fn(vals):
        x1 = big_value_hint(vals[0:NLIMBS], NLIMBS)
        y1 = big_value_hint(vals[NLIMBS:2 * NLIMBS], NLIMBS)
        x2 = big_value_hint(vals[2 * NLIMBS:3 * NLIMBS], NLIMBS)
        y2 = big_value_hint(vals[3 * NLIMBS:], NLIMBS)
        dx = (x2 - x1) % m
        s = ((y2 - y1) % m) * pow(dx, -1, m) % m if dx else 0
        return limbs_of_int(s, NLIMBS)

    outs = b.hint(list(p.x.big.limbs) + list(p.y.big.limbs) +
                  list(q.x.big.limbs) + list(q.y.big.limbs), NLIMBS, slope_fn)
    s = NNTarget(big_from_vars(b, outs), m)
    dx = nn_sub(b, q.x, p.x)
    dy = nn_sub(b, q.y, p.y)
    big_assert_eq(b, nn_mul(b, s, dx).big, dy.big)
    s2 = nn_mul(b, s, s)
    x3 = _linear_mod(b, [(1, s2), (-1, p.x), (-1, q.x)], m)
    y3 = nn_sub(b, nn_mul(b, s, nn_sub(b, p.x, x3)), p.y)
    return PointTarget(x3, y3)


def point_double(b: CircuitBuilder, p: PointTarget) -> PointTarget:
    """s = 3x^2 / 2y hinted: s*2y == 3x^2 (curve.rs:147-169 semantics)."""
    m = p.x.modulus

    def slope_fn(vals):
        x = big_value_hint(vals[0:NLIMBS], NLIMBS)
        y = big_value_hint(vals[NLIMBS:], NLIMBS)
        s = (3 * x * x) % m * pow((2 * y) % m, -1, m) % m if y else 0
        return limbs_of_int(s, NLIMBS)

    outs = b.hint(list(p.x.big.limbs) + list(p.y.big.limbs), NLIMBS, slope_fn)
    s = NNTarget(big_from_vars(b, outs), m)
    x2 = nn_mul(b, p.x, p.x)
    two_y = _linear_mod(b, [(1, p.y), (1, p.y)], m)
    three_x2 = _linear_mod(b, [(1, x2), (1, x2), (1, x2)], m)
    big_assert_eq(b, nn_mul(b, s, two_y).big, three_x2.big)
    s2 = nn_mul(b, s, s)
    x3 = _linear_mod(b, [(1, s2), (-1, p.x), (-1, p.x)], m)
    y3 = nn_sub(b, nn_mul(b, s, nn_sub(b, p.x, x3)), p.y)
    return PointTarget(x3, y3)


def point_assert_on_curve(b: CircuitBuilder, p: PointTarget):
    """y^2 == x^3 + 7 (curve.rs:118-130): y^2 - x*(x^2) certificate via two
    muls and a linear identity."""
    y2 = nn_mul(b, p.y, p.y)
    x2 = nn_mul(b, p.x, p.x)
    x3 = nn_mul(b, x2, p.x)
    diff = _linear_mod(b, [(1, y2), (-1, x3)], p.x.modulus)
    big_assert_eq(b, diff.big, big_constant(b, 7, NLIMBS))


def _add_const(p1, p2):
    if p1 is None:
        return p2
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2 and (y1 + y2) % Q == 0:
        return None
    if p1 == p2:
        s = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        s = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (s * s - x1 - x2) % Q
    return (x3, (s * (x1 - x3) - y1) % Q)


def _mult(k, point):
    """Host-side scalar mul for precomputed constants."""
    acc = None
    base = point
    while k:
        if k & 1:
            acc = _add_const(acc, base)
        base = _add_const(base, base)
        k >>= 1
    return acc


def _nothing_up_sleeve_point(tag: bytes):
    """Curve point with UNKNOWN discrete log: x = sha256(tag || ctr) mod Q,
    first ctr whose x^3+7 is a QR, even-y root (Q = 3 mod 4).  The role of
    the reference's hardcoded random blinding points (glv.rs:310-384), but
    verifiably nothing-up-sleeve."""
    import hashlib
    ctr = 0
    while True:
        x = int.from_bytes(
            hashlib.sha256(tag + ctr.to_bytes(4, "big")).digest(), "big") % Q
        rhs = (x * x * x + 7) % Q
        y = pow(rhs, (Q + 1) // 4, Q)
        if y * y % Q == rhs:
            return (x, y if y % 2 == 0 else Q - y)
        ctr += 1


# Blinding point for incomplete-add avoidance.  The dlog of B w.r.t. G (and
# any PK) is unknown, so every potential degenerate add (x1 == x2) in the
# ladders below would yield a nontrivial dlog relation involving B — i.e.
# neither an honest prover (any input data) nor a malicious one can reach
# the unconstrained-slope case of the incomplete add formula.  An earlier
# revision used D = 31337*G; with a KNOWN-dlog blind the degeneracies are
# input-reachable (a zero top window of the scalar made acc == table[0]
# exactly) — found by the e2e ECDSA fixture, see tests/test_ecdsa_e2e.py.
B_POINT = _nothing_up_sleeve_point(b"tpu_acir_prover/blind/v1/")


def scalar_mul(b: CircuitBuilder, p: PointTarget, scalar_bits: List[int],
               blind: Tuple[int, int] = None) -> PointTarget:
    """Double-and-add over little-endian scalar bits with a blinding
    accumulator seed (curve.rs:218-258 role).  acc = c*B + partial*p with
    c = 2^i after i steps; acc == +-p at an add would give a dlog relation
    for B, so the incomplete-add degenerate case is unreachable."""
    nb = len(scalar_bits)
    blind = blind or B_POINT
    acc = point_constant(b, blind)
    for bit in reversed(scalar_bits):
        acc = point_double(b, acc)
        added = point_add(b, acc, p)
        acc = point_select(b, bit, added, acc)
    # subtract blind * 2^nb
    unblind = _mult(pow(2, nb, N_SCALAR), blind)
    neg_unblind = (unblind[0], (Q - unblind[1]) % Q)
    return point_add(b, acc, point_constant(b, neg_unblind))


def windowed_scalar_mul(b: CircuitBuilder, p: PointTarget,
                        scalar_bits: List[int], window: int = 4,
                        blind: Tuple[int, int] = None) -> PointTarget:
    """Variable-base windowed double-and-add: an in-circuit table of the
    first 2^w multiples of p offset by the blinding point B, one add per
    window, w doubles between windows — the variable-base analog of the
    reference's GLV windowed MSM (glv.rs:175-255).

    Degeneracy freedom: the FIRST window is a direct table mux (no seed
    add), so acc = partial*p + c*B with c = sum_i 2^(window*i) >= 17 at
    every subsequent add against table[j] = j*p + B — an x1 == x2 event
    would yield a dlog relation for B.  (An earlier revision seeded acc
    with the same blind as the table, making acc == table[0] exactly when
    the scalar's top window is zero — a REACHABLE degenerate incomplete
    add, caught by the e2e ECDSA fixture.)"""
    nb = len(scalar_bits)
    blind = blind or B_POINT
    bpt = point_constant(b, blind)
    # table[j] = j*p + B
    table = [bpt]
    for j in range(1, 1 << window):
        table.append(point_add(b, table[-1], p))
    acc = None
    num_windows = 0
    for w0 in range(((nb + window - 1) // window) * window - window, -1,
                    -window):
        bits = scalar_bits[w0:w0 + window]
        oh = _onehot(b, bits)
        t = _mux_points(b, oh, table[:1 << len(bits)])
        if acc is None:
            acc = t
        else:
            for _ in range(window):
                acc = point_double(b, acc)
            acc = point_add(b, acc, t)
        num_windows += 1
    # accumulated blinding: one B per window, doubled along:
    # c_k = 2^window * c_{k-1} + 1 with c_1 = 1
    off = 0
    for _ in range(num_windows):
        off = (off << window) + 1
    offset = _mult(off % N_SCALAR, blind)
    neg = (offset[0], (Q - offset[1]) % Q)
    return point_add(b, acc, point_constant(b, neg))


def fixed_base_mul(b: CircuitBuilder, point_xy: Tuple[int, int],
                   scalar_bits: List[int], window: int = 4) -> PointTarget:
    """Fixed-base windowed scalar mul (no in-circuit doublings; the
    fixed-base analog of the reference GLV windowing, glv.rs:175-255):
    table_w[j] = (j * 2^w0) * P + 2^widx * B, so every window adds exactly
    one table point and the total offset (2^num_windows - 1) * B is a
    known constant subtracted at the end.

    Per-window blind multiples 2^widx keep the running blind coefficient
    (a strict subset-sum of powers of two) distinct from every table
    entry's, so an x1 == x2 event at any add would yield a dlog relation
    for B — unreachable for any scalar value."""
    nb = len(scalar_bits)
    acc = None
    widx = 0
    for w0 in range(0, nb, window):
        bits = scalar_bits[w0:w0 + window]
        base = _mult(1 << w0, point_xy)
        bl = _mult((1 << widx) % N_SCALAR, B_POINT)
        table = []
        for j in range(1 << len(bits)):
            pt = _mult(j, base)
            table.append(_add_const(pt, bl))
        oh = _onehot(b, bits)
        t = _mux_const_points(b, oh, table)
        acc = t if acc is None else point_add(b, acc, t)
        widx += 1
    offset = _mult(((1 << widx) - 1) % N_SCALAR, B_POINT)
    neg = (offset[0], (Q - offset[1]) % Q)
    return point_add(b, acc, point_constant(b, neg))
