"""SHA-256 of a message as chained ``Sha256Compression`` opcodes: the
analog of the reference's ``sha256_long`` fixture (SHA-256 of a 250-byte
message, ``tests/factories/noir_circuits_for_testing/sha256_long``).

The opcodes are those of the port's ``utils/circuits.sha256_multiblock``
(copied as it stood): witnesses 0-7 hold the IV; block i's 16 message
words follow, then its 8 output words, which are block i + 1's state; the
last block's outputs are the program's return values.  The message words
are the FIPS 180-4 padding of the message (section 5.1.1), so the returned
words are its digest.  Configuration keys: ``message_bytes``.
"""

from __future__ import annotations

import hashlib
import struct

from ..frozen.acir import ir
from ..frozen.field.gl import P
from ..frozen.ops.sha256 import K as SHA_K

SHA_IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def pad(message: bytes):
    """FIPS 180-4 5.1.1: the message, a 1 bit, zeros to 448 mod 512 bits,
    the bit length as 64 bits big-endian; as 16-word blocks."""
    data = message + b"\x80" + b"\0" * ((55 - len(message)) % 64) + \
        struct.pack(">Q", 8 * len(message))
    words = struct.unpack(f">{len(data) // 4}I", data)
    return [list(words[i:i + 16]) for i in range(0, len(words), 16)]


def compress(state, block_words):
    """Textbook SHA-256 compression of one 16-word block."""
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


def _fi(w):
    return ir.FunctionInput(w, 32)


def program_for_blocks(num_blocks: int) -> ir.Program:
    ops = []
    state_ws = list(range(8))
    w = 8
    private = list(range(8))
    for _ in range(num_blocks):
        msg_ws = list(range(w, w + 16))
        out_ws = list(range(w + 16, w + 24))
        ops.append(ir.BlackBoxSha256Compression(
            tuple(_fi(x) for x in msg_ws), tuple(_fi(x) for x in state_ws),
            tuple(out_ws)))
        private += msg_ws
        state_ws = out_ws
        w += 24
    c = ir.Circuit(w, ops, None, tuple(private), (), tuple(state_ws))
    return ir.Program([c])


def witness_for_blocks(blocks) -> dict:
    wm = {i: v for i, v in enumerate(SHA_IV)}
    state = list(SHA_IV)
    w = 8
    for words in blocks:
        state = compress(state, words)
        for i, v in enumerate(list(words) + state):
            wm[w + i] = v % P
        w += 24
    return wm


def build(cfg) -> ir.Program:
    return program_for_blocks(len(pad(bytes(cfg["message_bytes"]))))


def draw(cfg, rng) -> dict:
    return {"message": rng.randbytes(cfg["message_bytes"]).hex()}


def witness(cfg, inputs) -> dict:
    return witness_for_blocks(pad(bytes.fromhex(inputs["message"])))


def check(cfg, inputs, witness_map) -> int:
    message = bytes.fromhex(inputs["message"])
    digest = struct.unpack(">8I", hashlib.sha256(message).digest())
    first = 8 + 24 * (len(pad(message)) - 1) + 16
    return sum(witness_map.get(first + i) != d for i, d in enumerate(digest))
