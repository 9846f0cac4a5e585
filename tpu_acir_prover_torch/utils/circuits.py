"""The ACIR programs the port proves outside its tests: the fourteen small
example programs of ``ALL_SMALL`` (``examples/run_examples_torch.py``),
the heavy programs of ``ALL_HEAVY``, the ``ecdsa_secp256k1`` flagship
(``chip_smoke.py``, ``bench_torch.py``) and the SHA-256 circuits
(``chip_smoke.py``), each with its solved witness map.

A copy of the builders from ``expr`` to ``array_dynamic``, of
``SHA_IV``, ``sha256_compress``, ``sha256_multiblock``, ``_ecdsa_sign``,
``ecdsa_secp256k1``, ``ALL_SMALL`` and ``ALL_HEAVY`` in
``tests/factories.py``, built on the port's ``acir/ir.py``, and of the
one-compression circuit of ``tests/test_sha256.py``
(``sha256_compression``); ``tests/test_torch_host.py`` and
``tests/test_torch_sha256.py`` hold the program bytes and witness maps
equal to the originals'.
"""

import numpy as np

from ..acir import ir
from ..field.gl import P
from ..ops.sha256 import K as SHA_K


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

def assert_x_equals_5():
    """fixture assert_x_equals_5: public x; assert(x == 5)."""
    c = circuit([ir.AssertZero(expr(lin=[(1, 0)], q_c=-5))], 1, public=(0,))
    return program(c), {0: 5}


def one_mul():
    """fixture 1_mul: z = x*y; assert via return witness."""
    ops = [ir.AssertZero(expr(mul=[(1, 0, 1)], lin=[(P - 1, 2)]))]
    c = circuit(ops, 3, private=(0, 1), ret=(2,))
    return program(c), {0: 3, 1: 5, 2: 15}


def three_add():
    """fixture 3_add: w3 = x + y + z."""
    ops = [ir.AssertZero(expr(lin=[(1, 0), (1, 1), (1, 2), (P - 1, 3)]))]
    c = circuit(ops, 4, private=(0, 1, 2), ret=(3,))
    return program(c), {0: 10, 1: 20, 2: 12, 3: 42}


def five_over():
    """fixture 5_over: x > 5 via range-checked difference (x - 6 in 32 bits)."""
    ops = [
        ir.AssertZero(expr(lin=[(1, 0), (P - 1, 1)], q_c=-6)),
        ir.BlackBoxRange(fi(1, 32)),
    ]
    c = circuit(ops, 2, private=(0,))
    return program(c), {0: 11, 1: 5}


def quadratic_mixed():
    """mixed quadratic+linear expression (test_assert_zero.rs shapes):
    2xy + 3x + 4y + c - out = 0."""
    ops = [ir.AssertZero(expr(mul=[(2, 0, 1)], lin=[(3, 0), (4, 1), (P - 1, 2)],
                              q_c=7))]
    x, y = 9, 11
    out = (2 * x * y + 3 * x + 4 * y + 7) % P
    c = circuit(ops, 3, private=(0, 1), public=(2,))
    return program(c), {0: x, 1: y, 2: out}


def range_check(bits=32, value=None):
    """RANGE blackbox at various widths (test_blackbox.rs:8-107)."""
    if value is None:
        value = (1 << bits) - 1
    c = circuit([ir.BlackBoxRange(fi(0, bits))], 1, private=(0,))
    return program(c), {0: value}


def bitwise(kind="xor", bits=32, x=0xA5A5_5A5A, y=0x0F0F_F0F0):
    mask = (1 << bits) - 1
    x &= mask
    y &= mask
    out = (x ^ y) if kind == "xor" else (x & y)
    cls = ir.BlackBoxXor if kind == "xor" else ir.BlackBoxAnd
    c = circuit([cls(fi(0, bits), fi(1, bits), 2)], 3, private=(0, 1), ret=(2,))
    return program(c), {0: x, 1: y, 2: out}


def basic_memory_read(values=(7, 11, 13, 17), index=2):
    """MemoryInit + read at dynamic index (basic_memory_* fixtures)."""
    n = len(values)
    ops = [
        ir.MemoryInit(0, tuple(range(n))),
        ir.MemoryOp(0, ir.MemOp(expr(q_c=0), expr(lin=[(1, n)]),
                                expr(lin=[(1, n + 1)]))),
    ]
    c = circuit(ops, n + 2, private=tuple(range(n)) + (n,), ret=(n + 1,))
    wm = {i: v for i, v in enumerate(values)}
    wm[n] = index
    wm[n + 1] = values[index]
    return program(c), wm


def memory_write_then_read(values=(1, 2, 3, 4, 5), windex=1, wvalue=42,
                           rindex=1):
    """basic_memory_write fixture shape: write then read back."""
    n = len(values)
    w_wi, w_wv, w_ri, w_rv = n, n + 1, n + 2, n + 3
    ops = [
        ir.MemoryInit(0, tuple(range(n))),
        ir.MemoryOp(0, ir.MemOp(expr(q_c=1), expr(lin=[(1, w_wi)]),
                                expr(lin=[(1, w_wv)]))),
        ir.MemoryOp(0, ir.MemOp(expr(q_c=0), expr(lin=[(1, w_ri)]),
                                expr(lin=[(1, w_rv)]))),
    ]
    c = circuit(ops, n + 4, private=tuple(range(n)) + (w_wi, w_wv, w_ri),
                ret=(w_rv,))
    wm = {i: v for i, v in enumerate(values)}
    wm[w_wi] = windex
    wm[w_wv] = wvalue
    wm[w_ri] = rindex
    final = list(values)
    final[windex] = wvalue
    wm[w_rv] = final[rindex]
    return program(c), wm


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


def seven_function(x=9):
    """fixture 7_function shape: a Call opcode in the stream (translation
    no-op, mod.rs:98-104 — callee outputs arrive pre-solved in the witness
    file) whose output is then constrained by main's own AssertZero."""
    # w0 = x (private), w1 = x + 1 via AssertZero, Call f(w1) -> w2,
    # main asserts w2 == w1 (the inlined callee is the identity)
    ops = [
        ir.AssertZero(expr(lin=[(1, 0), (P - 1, 1)], q_c=1)),
        ir.Call(1, (1,), (2,)),
        ir.AssertZero(expr(lin=[(1, 1), (P - 1, 2)])),
    ]
    c = circuit(ops, 3, private=(0,), ret=(2,))
    return program(c), {0: x, 1: x + 1, 2: x + 1}


def array_dynamic(values=(10, 20, 30, 40, 50), windex=3, wvalue=77,
                  rindex1=1, rindex2=3):
    """fixture array_dynamic shape: non-power-of-two block (padded to 8,
    memory_translator.rs:141-151), dynamic read, dynamic write, read-back —
    exercising the index restriction against the real length."""
    n = len(values)
    w_r1i, w_r1v = n, n + 1
    w_wi, w_wv = n + 2, n + 3
    w_r2i, w_r2v = n + 4, n + 5
    ops = [
        ir.MemoryInit(0, tuple(range(n))),
        ir.MemoryOp(0, ir.MemOp(expr(q_c=0), expr(lin=[(1, w_r1i)]),
                                expr(lin=[(1, w_r1v)]))),
        ir.MemoryOp(0, ir.MemOp(expr(q_c=1), expr(lin=[(1, w_wi)]),
                                expr(lin=[(1, w_wv)]))),
        ir.MemoryOp(0, ir.MemOp(expr(q_c=0), expr(lin=[(1, w_r2i)]),
                                expr(lin=[(1, w_r2v)]))),
    ]
    c = circuit(ops, n + 6,
                private=tuple(range(n)) + (w_r1i, w_wi, w_wv, w_r2i),
                ret=(w_r1v, w_r2v))
    wm = {i: v for i, v in enumerate(values)}
    wm[w_r1i] = rindex1
    wm[w_r1v] = values[rindex1]
    wm[w_wi] = windex
    wm[w_wv] = wvalue
    final = list(values)
    final[windex] = wvalue
    wm[w_r2i] = rindex2
    wm[w_r2v] = final[rindex2]
    return program(c), wm


# --- SHA-256 -------------------------------------------------------------------

SHA_IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

# The most chained blocks whose circuit still compiles to 2^20 rows: a
# block is 39,136 builder rows and the chain 66 more, so 26 blocks take
# 1,017,602 rows (97 % of 2^20) and 27 would take 1,056,738, past 2^20.
SHA_LONG_BLOCKS = 26


def sha256_compress(state, block_words):
    """Textbook SHA-256 compression of one 16-word block (host)."""
    M = 0xFFFFFFFF

    def rotr(x, r):
        return ((x >> r) | (x << (32 - r))) & M

    w = list(block_words)
    for i in range(16, 64):
        s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + SHA_K[i] + w[i]) & M
        S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & M
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M, c, b, a, (t1 + t2) & M
    return [(x + y) & M for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_compression(seed=3):
    """One Sha256Compression opcode: 16 random message words (from
    ``seed``) and the IV as private inputs, the 8 output words returned;
    2^16 rows."""
    rng = np.random.default_rng(seed)
    msg = [int(x) for x in rng.integers(0, 1 << 32, size=16)]
    out = sha256_compress(SHA_IV, msg)
    op = ir.BlackBoxSha256Compression(
        tuple(fi(i, 32) for i in range(16)),
        tuple(fi(16 + i, 32) for i in range(8)),
        tuple(range(24, 32)))
    c = circuit([op], 32, private=tuple(range(24)), ret=tuple(range(24, 32)))
    wm = {i: v for i, v in enumerate(msg + SHA_IV + out)}
    return program(c), wm


def sha256_multiblock(num_blocks=2, seed=0x1234):
    """sha256_long analog: num_blocks chained Sha256Compression opcodes —
    block i's state inputs are block i-1's output witnesses."""
    wm = {}
    w = 0
    state_ws = []
    for i in range(8):
        wm[w] = SHA_IV[i]
        state_ws.append(w)
        w += 1
    state_vals = list(SHA_IV)
    ops = []
    for blk in range(num_blocks):
        msg_ws = []
        msg_vals = []
        for i in range(16):
            v = (seed * (blk * 16 + i + 1) * 2654435761) & 0xFFFFFFFF
            wm[w] = v
            msg_ws.append(w)
            msg_vals.append(v)
            w += 1
        out_ws = list(range(w, w + 8))
        state_vals = sha256_compress(state_vals, msg_vals)
        for ow, ov in zip(out_ws, state_vals):
            wm[ow] = ov
        w += 8
        ops.append(ir.BlackBoxSha256Compression(
            tuple(fi(x, 32) for x in msg_ws),
            tuple(fi(x, 32) for x in state_ws),
            tuple(out_ws)))
        state_ws = out_ws
    priv = tuple(range(8)) + tuple(
        x for op in ops for x in (f.witness for f in op.inputs))
    c = circuit(ops, w, private=priv, ret=tuple(state_ws))
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


ALL_SMALL = {
    "assert_x_equals_5": assert_x_equals_5,
    "1_mul": one_mul,
    "3_add": three_add,
    "5_over": five_over,
    "quadratic_mixed": quadratic_mixed,
    "range_8": lambda: range_check(8),
    "range_33": lambda: range_check(33),
    "xor_32": lambda: bitwise("xor", 32),
    "and_8": lambda: bitwise("and", 8),
    "memory_read": basic_memory_read,
    "memory_write": memory_write_then_read,
    "fibonacci": fibonacci,
    "7_function": seven_function,
    "array_dynamic": array_dynamic,
}

# Heavy programs (the sha256_long and ecdsa_secp256k1 classes)
ALL_HEAVY = {
    "sha256_multiblock": sha256_multiblock,
    "ecdsa_secp256k1": ecdsa_secp256k1,
}
