"""Goldilocks field arithmetic on numpy 32-bit limb pairs (host side).

A copy of the limb namespace ``make_gl`` in ``tpu_acir_prover/field/gl.py``
with numpy as its only backend (no JAX switch, no u64 path): a field
element is a pair of uint32 arrays ``(lo, hi)`` with value
``hi * 2^32 + lo`` kept canonical (< p).  The circuit compiler's host
witness fallback and powers tables, and the verifier's helpers, use it; the
prover's device arithmetic is ``field/gl.py``.
"""

from __future__ import annotations

import numpy as _np

from .gl import P

P_LO = _np.uint32(P & 0xFFFFFFFF)  # = 1
P_HI = _np.uint32(P >> 32)  # = 0xFFFFFFFF


def make_gl(xp=_np):
    """Build the Goldilocks op namespace over numpy.

    Every function takes/returns uint32 arrays; field elements are (lo, hi)
    tuples of equal-shape arrays.
    """
    u32 = xp.uint32

    def const(v, shape=()):
        v = int(v) % P
        lo = xp.full(shape, v & 0xFFFFFFFF, dtype=u32)
        hi = xp.full(shape, v >> 32, dtype=u32)
        return lo, hi

    def _ge_p(lo, hi):
        # value >= p  <=>  hi == 0xFFFFFFFF and lo >= 1  (since p = (2^32-1)<<32 | 1)
        return (hi == u32(0xFFFFFFFF)) & (lo >= u32(1))

    def _sub_p(lo, hi):
        # subtract p assuming value >= p: lo-1 with borrow, hi - 0xFFFFFFFF - borrow
        borrow = (lo < u32(1)).astype(u32)
        nlo = lo - u32(1)
        nhi = hi - u32(0xFFFFFFFF) - borrow
        return nlo, nhi

    def canon(lo, hi):
        """Conditionally subtract p once (input < 2p assumed)."""
        ge = _ge_p(lo, hi)
        slo, shi = _sub_p(lo, hi)
        return xp.where(ge, slo, lo), xp.where(ge, shi, hi)

    def add(a, b):
        alo, ahi = a
        blo, bhi = b
        slo = alo + blo
        c = (slo < alo).astype(u32)
        t = ahi + c
        c1 = (t < ahi).astype(u32)
        shi2 = t + bhi
        c2 = (shi2 < t).astype(u32)
        # overflowed past 2^64: value ≡ s + EPSILON (mod p)
        ovf = (c1 + c2) > u32(0)
        elo = slo + u32(0xFFFFFFFF)
        ec = (elo < slo).astype(u32)
        ehi = shi2 + ec
        lo = xp.where(ovf, elo, slo)
        hi = xp.where(ovf, ehi, shi2)
        return canon(lo, hi)

    def neg(a):
        alo, ahi = a
        is_zero = (alo == u32(0)) & (ahi == u32(0))
        # p - a
        borrow = (P_LO < alo).astype(u32)
        nlo = P_LO - alo
        nhi = P_HI - ahi - borrow
        return xp.where(is_zero, u32(0), nlo), xp.where(is_zero, u32(0), nhi)

    def sub(a, b):
        return add(a, neg(b))

    def mul_32_32(a, b):
        """u32 * u32 -> (lo, hi) u64 product via 16-bit limbs."""
        a0 = a & u32(0xFFFF)
        a1 = a >> u32(16)
        b0 = b & u32(0xFFFF)
        b1 = b >> u32(16)
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        mid = p01 + p10
        mid_c = (mid < p01).astype(u32)  # carry out of mid (bit 32)
        mid_lo = mid << u32(16)
        mid_hi = (mid >> u32(16)) + (mid_c << u32(16))
        lo = p00 + mid_lo
        c = (lo < p00).astype(u32)
        hi = p11 + mid_hi + c
        return lo, hi

    def _add64(alo, ahi, blo, bhi):
        """64-bit add returning (lo, hi, carry_out)."""
        slo = alo + blo
        c = (slo < alo).astype(u32)
        t = ahi + c
        c1 = (t < ahi).astype(u32)
        shi = t + bhi
        c2 = (shi < t).astype(u32)
        return slo, shi, c1 + c2

    def mul_wide(a, b):
        """Full 64x64 -> 128-bit product as four u32 words (x0..x3)."""
        alo, ahi = a
        blo, bhi = b
        ll_lo, ll_hi = mul_32_32(alo, blo)  # 2^0
        lh_lo, lh_hi = mul_32_32(alo, bhi)  # 2^32
        hl_lo, hl_hi = mul_32_32(ahi, blo)  # 2^32
        hh_lo, hh_hi = mul_32_32(ahi, bhi)  # 2^64
        # x1 accumulation: ll_hi + lh_lo + hl_lo
        x1 = ll_hi + lh_lo
        c1 = (x1 < ll_hi).astype(u32)
        x1b = x1 + hl_lo
        c2 = (x1b < x1).astype(u32)
        carry_x1 = c1 + c2  # 0..2
        # x2 accumulation: lh_hi + hl_hi + hh_lo + carry_x1
        x2 = lh_hi + hl_hi
        c3 = (x2 < lh_hi).astype(u32)
        x2b = x2 + hh_lo
        c4 = (x2b < x2).astype(u32)
        x2c = x2b + carry_x1
        c5 = (x2c < x2b).astype(u32)
        carry_x2 = c3 + c4 + c5
        x3 = hh_hi + carry_x2
        return ll_lo, x1b, x2c, x3

    def reduce128(x0, x1, x2, x3):
        """Reduce a 128-bit value (x3:x2:x1:x0 u32 words) mod p.

        Uses 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p):
          x ≡ (x1:x0) - x3 + x2 * (2^32 - 1)
        """
        # t = (x1:x0) - x3, with borrow handled as -2^64 ≡ -EPSILON
        borrow = (x0 < x3).astype(u32)
        t_lo = x0 - x3
        t_hi = x1 - borrow
        und = (x1 < borrow)  # 64-bit underflow happened
        # if underflow: subtract EPSILON from (t mod 2^64); t >= 2^64-2^32 so no chain issue
        b2 = (t_lo < u32(0xFFFFFFFF)).astype(u32)
        u_lo = t_lo - u32(0xFFFFFFFF)
        u_hi = t_hi - b2
        t_lo = xp.where(und, u_lo, t_lo)
        t_hi = xp.where(und, u_hi, t_hi)
        # t2 = x2 * EPSILON = (x2 << 32) - x2 : compute as u64
        e_lo_, e_hi_ = mul_32_32(x2, u32(0xFFFFFFFF))
        # r = t + t2, carry ≡ +EPSILON
        r_lo, r_hi, cry = _add64(t_lo, t_hi, e_lo_, e_hi_)
        has_c = cry > u32(0)
        a_lo = r_lo + u32(0xFFFFFFFF)
        ac = (a_lo < r_lo).astype(u32)
        a_hi = r_hi + ac
        r_lo = xp.where(has_c, a_lo, r_lo)
        r_hi = xp.where(has_c, a_hi, r_hi)
        return canon(r_lo, r_hi)

    def mul(a, b):
        x0, x1, x2, x3 = mul_wide(a, b)
        return reduce128(x0, x1, x2, x3)

    def sqr(a):
        return mul(a, a)

    def mul_const(a, c):
        return mul(a, const(c, xp.shape(a[0])))

    def pow_const(a, e):
        """a ** e for python-int exponent e (square-and-multiply, static)."""
        e = int(e)
        result = const(1, xp.shape(a[0]))
        base = a
        while e > 0:
            if e & 1:
                result = mul(result, base)
            base = mul(base, base)
            e >>= 1
        return result

    def inv(a):
        """Inverse via Fermat: a^(p-2). a must be nonzero."""
        return pow_const(a, P - 2)

    def to_u64(a):
        """(lo, hi) -> numpy uint64 (host only; materializes)."""
        lo = _np.asarray(a[0], dtype=_np.uint64)
        hi = _np.asarray(a[1], dtype=_np.uint64)
        return (hi << _np.uint64(32)) | lo

    def from_u64(v):
        v = _np.asarray(v, dtype=_np.uint64)
        lo = xp.asarray((v & _np.uint64(0xFFFFFFFF)).astype(_np.uint32))
        hi = xp.asarray((v >> _np.uint64(32)).astype(_np.uint32))
        return lo, hi

    def select(cond, a, b):
        return xp.where(cond, a[0], b[0]), xp.where(cond, a[1], b[1])

    def is_zero(a):
        return (a[0] == u32(0)) & (a[1] == u32(0))

    def eq(a, b):
        return (a[0] == b[0]) & (a[1] == b[1])

    ns = dict(
        const=const, canon=canon, add=add, sub=sub, neg=neg, mul=mul, sqr=sqr,
        mul_const=mul_const, pow_const=pow_const, inv=inv, mul_32_32=mul_32_32,
        mul_wide=mul_wide, reduce128=reduce128, to_u64=to_u64, from_u64=from_u64,
        select=select, is_zero=is_zero, eq=eq, xp=xp,
    )
    return type("GL", (), ns)
