"""Noir's ``ecdsa_secp256k1`` fixture: one ``EcdsaSecp256k1`` opcode that
verifies a signature over secp256k1 and returns the verdict (the reference
backend's ``test_precompiled.rs:7-44`` program).

The opcode is laid out as the port's ``utils/circuits.ecdsa_secp256k1``
(copied as it stood): witnesses 0-31 hold the public key's x, 32-63 its y,
64-127 the signature (r then s), 128-159 the hashed message, each a
big-endian byte a witness, all private; witness 160 is the boolean output,
the program's return value.  Each proof is a fresh signer and message:
``draw`` takes a private key, a 32-byte message hash and a nonce from the
run's seed, ``witness`` signs in python ints and writes what ``nargo
execute`` would.  No configuration key is read.

``check`` verifies the signature in its own python-int arithmetic of the
curve (nothing of ``frozen/ops``), by the rule the reference backend's
circuit computes (``ecdsa_secp256k1_translator.rs:38-59``): the output is
1 where ``r <= R.x``, R = (h/s)·G + (r/s)·PK, compared as integers.
Textbook ECDSA accepts only where ``R.x mod n == r``.  The two agree on
every honest signature (then ``r == R.x mod n <= R.x``), but the
backend's rule also accepts a forged one whose R.x lies above r.
"""

from __future__ import annotations

from ..frozen.acir import ir

# secp256k1 (SEC 2, section 2.4.1): the base field, the group order, G
FIELD = 2 ** 256 - 2 ** 32 - 977
ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
# the byte-array inputs in witness order: public key x, y, signature, hash
GROUPS = (32, 32, 64, 32)
OUTPUT = sum(GROUPS)


def add(p, q):
    """Affine sum of two points; None is the point at infinity."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % FIELD == 0:
        return None
    if p == q:
        slope = 3 * x1 * x1 * pow(2 * y1, -1, FIELD)
    else:
        slope = (y2 - y1) * pow(x2 - x1, -1, FIELD)
    x3 = (slope * slope - x1 - x2) % FIELD
    return (x3, (slope * (x1 - x3) - y1) % FIELD)


def mul(k: int, p):
    """k·p by double and add."""
    acc = None
    while k:
        if k & 1:
            acc = add(acc, p)
        p = add(p, p)
        k >>= 1
    return acc


def sign(private_key: int, msg_hash: int, nonce: int):
    """Textbook ECDSA: (r, s) with R = nonce·G, r = R.x mod n,
    s = (h + r·d) / nonce mod n."""
    r = mul(nonce, G)[0] % ORDER
    s = pow(nonce, -1, ORDER) * (msg_hash + r * private_key) % ORDER
    if r == 0 or s == 0:
        raise ValueError("degenerate nonce")
    return r, s


def backend_accepts(pk, r: int, s: int, msg_hash: int) -> int:
    """The reference backend's verdict: 1 where r <= R.x, with
    R = (h/s)·G + (r/s)·PK; 0 where R is the point at infinity."""
    s_inv = pow(s, -1, ORDER)
    big_r = add(mul(msg_hash * s_inv % ORDER, G),
                mul(r * s_inv % ORDER, pk))
    return int(big_r is not None and r <= big_r[0])


def _bytes(inputs, key: str) -> bytes:
    return bytes.fromhex(inputs[key])


def _fi(w):
    return ir.FunctionInput(w, 8)


def build(cfg) -> ir.Program:
    groups, w = [], 0
    for n in GROUPS:
        groups.append(tuple(_fi(w + i) for i in range(n)))
        w += n
    op = ir.BlackBoxEcdsaSecp256k1(*groups, OUTPUT)
    c = ir.Circuit(OUTPUT + 1, [op], None, tuple(range(OUTPUT)), (),
                   (OUTPUT,))
    return ir.Program([c])


def draw(cfg, rng) -> dict:
    """A signer's private key, the hash of its message and its nonce."""
    return {"private_key": (1 + rng.randrange(ORDER - 1)).to_bytes(32, "big")
            .hex(),
            "hashed_message": rng.randbytes(32).hex(),
            "nonce": (1 + rng.randrange(ORDER - 1)).to_bytes(32, "big").hex()}


def signed(inputs):
    """The public key, the signature and the message hash that the proof's
    witness file holds."""
    d = int.from_bytes(_bytes(inputs, "private_key"), "big")
    h = int.from_bytes(_bytes(inputs, "hashed_message"), "big")
    r, s = sign(d, h, int.from_bytes(_bytes(inputs, "nonce"), "big"))
    return mul(d, G), r, s, h


def witness_for(pk, r: int, s: int, msg_hash: int, output: int) -> dict:
    data = b"".join((pk[0].to_bytes(32, "big"), pk[1].to_bytes(32, "big"),
                     r.to_bytes(32, "big"), s.to_bytes(32, "big"),
                     msg_hash.to_bytes(32, "big")))
    wm = dict(enumerate(data))
    wm[OUTPUT] = output
    return wm


def witness(cfg, inputs) -> dict:
    pk, r, s, h = signed(inputs)
    return witness_for(pk, r, s, h, backend_accepts(pk, r, s, h))


def check(cfg, inputs, witness_map) -> int:
    """1 where the map's output is not the backend's verdict on the
    signature its input bytes hold, else 0."""
    data = bytes(witness_map.get(i, 0) for i in range(OUTPUT))
    x, y, r, s, h = (int.from_bytes(data[i:i + 32], "big")
                     for i in range(0, OUTPUT, 32))
    return int(witness_map.get(OUTPUT) != backend_accepts((x, y), r, s, h))
