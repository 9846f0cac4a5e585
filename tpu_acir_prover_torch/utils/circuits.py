"""The two ACIR programs ``chip_smoke.py`` proves: ``fibonacci`` and the
``ecdsa_secp256k1`` flagship, each with its solved witness map.

A copy of ``expr``, ``fi``, ``circuit``, ``program``, ``fibonacci``,
``_ecdsa_sign`` and ``ecdsa_secp256k1`` from ``tests/factories.py``, built
on the port's ``acir/ir.py``; ``tests/test_torch_host.py`` holds the
program bytes equal to the originals'.
"""

from ..acir import ir
from ..field.gl import P


def expr(mul=(), lin=(), q_c=0):
    return ir.Expression(tuple(mul), tuple(lin), q_c % P)


def fi(w, bits):
    return ir.FunctionInput(w, bits)


def circuit(opcodes, cwi, private=(), public=(), ret=()):
    return ir.Circuit(cwi, list(opcodes), None, tuple(private), tuple(public),
                      tuple(ret))


def program(c):
    return ir.Program([c])


# --- reference fixture analogs -------------------------------------------------


def fibonacci(n_steps=10, brillig_noise=True):
    """fibonacci example shape: AssertZero chain; optionally a BrilligCall
    opcode in the stream (ignored by translation, mod.rs:98-103)."""
    ops = []
    wm = {0: 1, 1: 1}
    for i in range(n_steps):
        ops.append(ir.AssertZero(
            expr(lin=[(1, i), (1, i + 1), (P - 1, i + 2)])))
        wm[i + 2] = (wm[i] + wm[i + 1]) % P
    if brillig_noise:
        ops.append(ir.BrilligCall(0, (("single", expr(lin=[(1, 0)])),),
                                  (("simple", n_steps + 2),)))
        wm[n_steps + 2] = wm[0]
    c = circuit(ops, n_steps + 3, private=(0, 1),
                public=(n_steps + 1,))
    return program(c), wm




def _ecdsa_sign(msg_hash: int, priv: int, k: int):
    """Host-side textbook ECDSA signature (for fixture construction only)."""
    from ..ops import secp256k1 as sec
    n = sec.N_SCALAR
    R = sec._mult(k, (sec.GX, sec.GY))
    r = R[0] % n
    s = pow(k, -1, n) * (msg_hash + r * priv) % n
    return r, s


def ecdsa_secp256k1(valid=True):
    """fixture ecdsa_secp256k1 (test_precompiled.rs:7-44): byte-array
    witnesses for pk_x/pk_y/signature/hashed_message, boolean output."""
    from ..ops import secp256k1 as sec
    priv = 0xC0FFEE1234567890C0FFEE1234567890C0FFEE1234567890C0FFEE1234567890
    pk = sec._mult(priv, (sec.GX, sec.GY))
    h = 0x9C1185A5C5E9FC54612808977EE8F548B2258D31A8D56F98AD214D06BBA2F9D2 \
        % sec.N_SCALAR
    r, s = _ecdsa_sign(h, priv, k=0xDEADBEEF)
    n = sec.N_SCALAR

    def _expected(sv):
        # the reference's quirky `r <= R.x` comparison
        # (ecdsa_secp256k1_translator.rs:38-59), computed host-side
        s_inv = pow(sv, -1, n)
        u1, u2 = h * s_inv % n, r * s_inv % n
        R = sec._add_const(sec._mult(u1, (sec.GX, sec.GY)), sec._mult(u2, pk))
        return 1 if r <= R[0] else 0

    if not valid:
        # a blind tamper flips the output only with prob ~1/2 under the
        # <=-comparison semantics; scan small tweaks for a deterministic 0
        for tweak in range(1, 64):
            if _expected(s ^ tweak) == 0:
                s ^= tweak
                break
        else:
            raise AssertionError("no tamper tweak produced output 0")
    expected = _expected(s)
    if valid:
        assert expected == 1
    else:
        assert expected == 0

    w = 0
    groups = []
    for ln in (32, 32, 64, 32):
        groups.append(tuple(fi(w + i, 8) for i in range(ln)))
        w += ln
    out_w = w
    op = ir.BlackBoxEcdsaSecp256k1(groups[0], groups[1], groups[2],
                                   groups[3], out_w)
    c = circuit([op], w + 1, private=tuple(range(w)), ret=(out_w,))
    wm = {}
    idx = 0
    for v, ln in ((pk[0], 32), (pk[1], 32), ((r << 256) | s, 64), (h, 32)):
        for byte in v.to_bytes(ln, "big"):
            wm[idx] = byte
            idx += 1
    wm[out_w] = expected
    return program(c), wm


