"""GLV endomorphism scalar multiplication for secp256k1.

Capability analog of the reference's vendored GLV stack
(plonky2-backend/src/plonky2_ecdsa/curve/gadgets/glv.rs):
host-side scalar decomposition k = k1 + lambda*k2 (glv.rs:50-88), an
in-circuit re-check of the decomposition (glv.rs:117-149), and a dual
half-width windowed MSM over P and phi(P) = (beta*x, y) sharing one
doubling chain (glv.rs:151-255).

secp256k1 admits the efficient endomorphism phi(x, y) = (beta*x, y) with
phi(P) = lambda*P, where lambda^3 = 1 mod n and beta^3 = 1 mod q.  The
short lattice basis for the decomposition is derived at import time by the
extended-Euclid procedure of the GLV paper (remainder pairs of gcd(n,
lambda) around sqrt(n)) rather than hardcoded, and verified:
a_i + b_i*lambda = 0 mod n with all |a_i|, |b_i| < 2^129.  Decomposed
halves satisfy |k1|, |k2| <= ~2^128; the circuit allots 132 bits.

Frozen for the benchmark's reference: a copy of the port's
``tpu_acir_prover_torch/ops/glv.py`` as it stood at commit c8d5fef,
its relative imports resolving inside ``prover_bench/frozen/``.
"""

from __future__ import annotations

from typing import List, Tuple

from ..circuit.builder import CircuitBuilder
from .bigint import (BigUintTarget, LIMB_BITS, big_from_vars, big_value_hint,
                     big_assert_eq, big_constant, limbs_of_int)
from .secp256k1 import (B_POINT, NLIMBS, NNTarget, PointTarget, Q, N_SCALAR,
                        _add_const, _linear_mod, _mult, _mux_points,
                        _nothing_up_sleeve_point, _onehot, nn_mul_const,
                        nn_select, point_add, point_constant, point_double,
                        point_select)

LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE

K_BITS = 132            # per-half scalar budget (observed max 128)
K_LIMBS = 9             # 8 full 16-bit limbs + one 4-bit top limb
K_TOP_BITS = K_BITS - 16 * (K_LIMBS - 1)

# second independent blinding point: the dual ladder muxes two tables in
# the same window, so their blinds must not coincide (see windowed_scalar_
# mul's degeneracy note in secp256k1.py)
B2_POINT = _nothing_up_sleeve_point(b"tpu_acir_prover/blind/v2/")


def _glv_basis() -> Tuple[int, int, int, int]:
    """Short vectors (a1, b1), (a2, b2) with a_i + b_i*lambda = 0 mod n,
    via the GLV-paper extended Euclid walk (glv.rs hardcodes the same
    values; deriving keeps them nothing-up-sleeve)."""
    rs = [N_SCALAR, LAMBDA]
    ts = [0, 1]
    while rs[-1] * rs[-1] >= N_SCALAR:
        q = rs[-2] // rs[-1]
        rs.append(rs[-2] - q * rs[-1])
        ts.append(ts[-2] - q * ts[-1])
    l = len(rs) - 1
    a1, b1 = rs[l], -ts[l]
    a2, b2 = rs[l - 1], -ts[l - 1]
    assert (a1 + b1 * LAMBDA) % N_SCALAR == 0
    assert (a2 + b2 * LAMBDA) % N_SCALAR == 0
    assert max(abs(a1), abs(b1), abs(a2), abs(b2)) < (1 << 129)
    return a1, b1, a2, b2


A1, B1, A2, B2 = _glv_basis()


def decompose_scalar(k: int) -> Tuple[int, int]:
    """k -> (k1, k2), signed, with k1 + k2*lambda = k mod n and
    |k_i| < 2^132 (glv.rs:50-88 decompose_secp256k1_scalar analog)."""
    k %= N_SCALAR
    c1 = (B2 * k + N_SCALAR // 2) // N_SCALAR
    c2 = (-B1 * k + N_SCALAR // 2) // N_SCALAR
    k1 = k - c1 * A1 - c2 * A2
    k2 = -c1 * B1 - c2 * B2
    assert (k1 + k2 * LAMBDA - k) % N_SCALAR == 0
    assert abs(k1) < (1 << K_BITS) and abs(k2) < (1 << K_BITS)
    return k1, k2


def _half_scalar_from_hint(b: CircuitBuilder, outs: List[int]):
    """Range-check one hinted half: [sign, 9 limbs] -> (sign_var, limbs,
    padded 16-limb BigUint).  Top limb is pinned to K_TOP_BITS so the
    ladder's 132 bits account for the entire committed value."""
    sign = outs[0]
    b.assert_bool(sign)
    limbs = list(outs[1:])
    for v in limbs[:-1]:
        b.range_check(v, LIMB_BITS)
    b.range_check(limbs[-1], K_TOP_BITS)
    padded = BigUintTarget(limbs + [b.zero] * (NLIMBS - K_LIMBS))
    return sign, limbs, padded


def _signed_nn(b: CircuitBuilder, sign: int, mag: BigUintTarget) -> NNTarget:
    """(-1)^sign * mag mod n as a nonnative value."""
    pos = NNTarget(mag, N_SCALAR)
    neg = _linear_mod(b, [(-1, pos)], N_SCALAR)
    return nn_select(b, sign, neg, pos)


def _negate_point(b: CircuitBuilder, p: PointTarget) -> PointTarget:
    return PointTarget(p.x, _linear_mod(b, [(-1, p.y)], Q))


def _half_bits(b: CircuitBuilder, limbs: List[int]) -> List[int]:
    bits = []
    for i, limb in enumerate(limbs):
        w = LIMB_BITS if i < len(limbs) - 1 else K_TOP_BITS
        bits.extend(b.split_le(limb, w))
    return bits


def glv_mul(b: CircuitBuilder, p: PointTarget, k: NNTarget,
            window: int = 4) -> PointTarget:
    """k*p via GLV split + dual windowed ladder with shared doublings
    (glv.rs:151-168 glv_mul + :175-255 curve_msm_circuit analog).

    Soundness: the hinted halves are re-checked in-circuit
    (k = s1*|k1| + lambda*s2*|k2| mod n, glv.rs:117-149 role) and their
    top limbs are pinned so the 132 ladder bits cover the committed
    values exactly.  Degenerate incomplete-adds are unreachable: the two
    window tables carry independent unknown-dlog blinds (B, B2) and the
    accumulator's blind coefficients differ from both after the first
    window."""
    assert k.modulus == N_SCALAR

    def fn(vals):
        kv = big_value_hint(vals, NLIMBS) % N_SCALAR
        k1, k2 = decompose_scalar(kv)
        return ([1 if k1 < 0 else 0] + limbs_of_int(abs(k1), K_LIMBS) +
                [1 if k2 < 0 else 0] + limbs_of_int(abs(k2), K_LIMBS))

    outs = b.hint(list(k.big.limbs), 2 * (1 + K_LIMBS), fn)
    s1, l1, m1 = _half_scalar_from_hint(b, outs[:1 + K_LIMBS])
    s2, l2, m2 = _half_scalar_from_hint(b, outs[1 + K_LIMBS:])

    # in-circuit decomposition re-check: k == t1 + lambda*t2 mod n
    t1 = _signed_nn(b, s1, m1)
    t2 = _signed_nn(b, s2, m2)
    rhs = _linear_mod(b, [(1, t1), (1, nn_mul_const(b, t2, LAMBDA))],
                      N_SCALAR)
    diff = _linear_mod(b, [(1, k), (-1, rhs)], N_SCALAR)
    big_assert_eq(b, diff.big, big_constant(b, 0, NLIMBS))

    # base points with signs folded in: |k1|*P1 + |k2|*P2
    p1 = point_select(b, s1, _negate_point(b, p), p)
    phi = PointTarget(nn_mul_const(b, p.x, BETA), p.y)
    p2 = point_select(b, s2, _negate_point(b, phi), phi)

    bits1 = _half_bits(b, l1)
    bits2 = _half_bits(b, l2)
    return _dual_windowed_msm(b, p1, bits1, p2, bits2, window)


def _dual_windowed_msm(b: CircuitBuilder, p1: PointTarget, bits1: List[int],
                       p2: PointTarget, bits2: List[int],
                       window: int = 4) -> PointTarget:
    """acc = sum over windows (MSB first) of 2^window*acc + t1[j1] + t2[j2]
    with t1[j] = j*p1 + B, t2[j] = j*p2 + B2; both blind coefficients
    follow c_k = 2^window*c_{k-1} + 1 and are subtracted as one host
    constant at the end."""
    nb = len(bits1)
    assert len(bits2) == nb

    tab1 = [point_constant(b, B_POINT)]
    tab2 = [point_constant(b, B2_POINT)]
    for j in range(1, 1 << window):
        tab1.append(point_add(b, tab1[-1], p1))
        tab2.append(point_add(b, tab2[-1], p2))

    acc = None
    num_windows = 0
    for w0 in range(((nb + window - 1) // window) * window - window, -1,
                    -window):
        oh1 = _onehot(b, bits1[w0:w0 + window])
        oh2 = _onehot(b, bits2[w0:w0 + window])
        t1 = _mux_points(b, oh1, tab1[:len(oh1)])
        t2 = _mux_points(b, oh2, tab2[:len(oh2)])
        if acc is None:
            acc = point_add(b, t1, t2)
        else:
            for _ in range(window):
                acc = point_double(b, acc)
            acc = point_add(b, acc, t1)
            acc = point_add(b, acc, t2)
        num_windows += 1

    off = 0
    for _ in range(num_windows):
        off = (off << window) + 1
    off %= N_SCALAR
    blind_total = _add_const(_mult(off, B_POINT), _mult(off, B2_POINT))
    neg = (blind_total[0], (Q - blind_total[1]) % Q)
    return point_add(b, acc, point_constant(b, neg))
