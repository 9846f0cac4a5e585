"""ECDSA secp256k1 signature verification in-circuit.

Capability analog of the reference's EcdsaSecp256k1Translator
(plonky2-backend/src/circuit_translation/
ecdsa_secp256k1_translator.rs): byte-array witnesses -> big integers,
R = (h * s^-1) * G + (r * s^-1) * PK, output boolean wired to the ACIR
output witness.

Behavioral parity notes:
  * the output check replicates the reference's `r <= R.x` comparison
    (cmp_biguint is <=, not strict equality mod n — SURVEY.md C11 flags
    this as a correctness quirk; we match the observable behavior);
  * fixed-base G uses constant window tables (no in-circuit doublings),
    variable-base PK uses the GLV endomorphism split + dual half-width
    windowed MSM (ops/glv.py, the glv.rs:50-255 analog).
We additionally assert PK is on the curve (y^2 = x^3 + 7), which the
reference leaves implicit.

Frozen for the benchmark's reference: a copy of the port's
``tpu_acir_prover_torch/ops/ecdsa.py`` as it stood at commit c8d5fef,
its relative imports resolving inside ``prover_bench/frozen/``.
"""

from __future__ import annotations

from typing import List

from .bigint import big_from_bytes_be, big_le_bool
from .glv import glv_mul
from .secp256k1 import (GX, GY, N_SCALAR, PointTarget, fixed_base_mul,
                        nn_assert_canonical, nn_from_big, nn_inv, nn_mul,
                        point_add, point_assert_on_curve, Q)


def _scalar_bits(b, nn) -> List[int]:
    """256 little-endian bits of a normalized 16-limb nonnative value."""
    bits = []
    for limb in nn.big.limbs:
        bits.extend(b.split_le(limb, 16))
    return bits


def verify_ecdsa_in_circuit(b, pk_x_bytes, pk_y_bytes, sig_bytes,
                            msg_bytes) -> int:
    """Returns the boolean result var (1 = signature valid)."""
    pk_x_big = big_from_bytes_be(b, pk_x_bytes)
    pk_y_big = big_from_bytes_be(b, pk_y_bytes)
    r_big = big_from_bytes_be(b, sig_bytes[:32])
    s_big = big_from_bytes_be(b, sig_bytes[32:])
    h_big = big_from_bytes_be(b, msg_bytes)

    r = nn_from_big(b, r_big, N_SCALAR)
    s = nn_from_big(b, s_big, N_SCALAR)
    h = nn_from_big(b, h_big, N_SCALAR)
    pk = PointTarget(nn_from_big(b, pk_x_big, Q), nn_from_big(b, pk_y_big, Q))
    point_assert_on_curve(b, pk)

    s_inv = nn_inv(b, s)
    u1 = nn_mul(b, h, s_inv)
    u2 = nn_mul(b, r, s_inv)

    r1 = fixed_base_mul(b, (GX, GY), _scalar_bits(b, u1))
    r2 = glv_mul(b, pk, u2)
    big_r = point_add(b, r1, r2)

    # R.x is only weakly normalized; pin it below the field modulus so the
    # integer comparison below is well-defined
    nn_assert_canonical(b, big_r.x)
    # reference quirk: result = (r <= R.x) via cmp_biguint
    # (ecdsa_secp256k1_translator.rs:38-59)
    return big_le_bool(b, r_big, big_r.x.big)


def translate_ecdsa_secp256k1(tr, op) -> None:
    b = tr.builder
    pk_x = [tr.var_for_witness(fi.witness) for fi in op.public_key_x]
    pk_y = [tr.var_for_witness(fi.witness) for fi in op.public_key_y]
    sig = [tr.var_for_witness(fi.witness) for fi in op.signature]
    msg = [tr.var_for_witness(fi.witness) for fi in op.hashed_message]
    result = verify_ecdsa_in_circuit(b, pk_x, pk_y, sig, msg)
    b.assert_equal(result, tr.var_for_witness(op.output))
