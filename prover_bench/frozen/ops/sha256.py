"""SHA-256 compression function in-circuit (one block, 64 rounds).

Capability analog of the reference's Sha256CompressionTranslator
(plonky2-backend/src/circuit_translation/sha256_translator.rs):
message schedule w[16..64], 64 rounds of Ch/Maj/Sigma over 32-bit words,
final state addition, outputs wired to the ACIR output witnesses.

Word representation: (value_var, bits) where bits is the LSB-first list of
boolean vars.  Rotations/shifts are free (bit-list reindexing, like the
reference's BinaryDigitsTarget reconnection, binary_digits_target.rs:20-63);
XOR/AND/Ch/Maj cost one-or-two universal gate rows per bit; additions mod
2^32 run in the field on the recombined values and re-split 32+carry bits
(cheaper on a PLONK gate than the reference's ripple-carry adder,
binary_digits_target.rs:182-214).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..circuit.builder import CircuitBuilder

K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]


@dataclass
class U32Word:
    value: int              # circuit var holding the u32 value
    bits: List[int]         # 32 boolean vars, LSB first


def word_from_var(b: CircuitBuilder, var: int) -> U32Word:
    return U32Word(var, b.split_le(var, 32))


def word_from_bits(b: CircuitBuilder, bits: List[int]) -> U32Word:
    return U32Word(b.le_sum_vars(bits), list(bits))


def rotr(w: U32Word, r: int) -> List[int]:
    """Rotate right by r: out bit i = in bit (i + r) mod 32 (free)."""
    return [w.bits[(i + r) % 32] for i in range(32)]


def shr(b: CircuitBuilder, w: U32Word, r: int) -> List[int]:
    """Logical shift right by r: high bits zero-filled."""
    return [w.bits[i + r] if i + r < 32 else b.zero for i in range(32)]


def xor3_bits(b: CircuitBuilder, xs, ys, zs) -> List[int]:
    return [b.bit_xor(b.bit_xor(x, y), z) for x, y, z in zip(xs, ys, zs)]


def add_words_mod32(b: CircuitBuilder, words: List, consts: int = 0) -> U32Word:
    """(sum of word values + consts) mod 2^32 via field add + re-split."""
    total = b.lincomb([(1, w.value) for w in words], consts)
    carry_bits = max(1, (len(words) + (1 if consts else 0) - 1).bit_length())
    bits = b.split_le(total, 32 + carry_bits)
    return word_from_bits(b, bits[:32])


def small_sigma0(b, w):   # rotr7 ^ rotr18 ^ shr3
    return xor3_bits(b, rotr(w, 7), rotr(w, 18), shr(b, w, 3))


def small_sigma1(b, w):   # rotr17 ^ rotr19 ^ shr10
    return xor3_bits(b, rotr(w, 17), rotr(w, 19), shr(b, w, 10))


def big_sigma0(b, w):     # rotr2 ^ rotr13 ^ rotr22
    return xor3_bits(b, rotr(w, 2), rotr(w, 13), rotr(w, 22))


def big_sigma1(b, w):     # rotr6 ^ rotr11 ^ rotr25
    return xor3_bits(b, rotr(w, 6), rotr(w, 11), rotr(w, 25))


def choose_bits(b: CircuitBuilder, e, f, g) -> List[int]:
    """Ch(e,f,g) = e ? f : g per bit (sha256_translator.rs choose)."""
    return [b.select(eb, fb, gb) for eb, fb, gb in zip(e.bits, f.bits, g.bits)]


def majority_bits(b: CircuitBuilder, x, y, z) -> List[int]:
    """Maj = xy + z*(x xor y) per bit (2 muls + 1 select-like row)."""
    out = []
    for xb, yb, zb in zip(x.bits, y.bits, z.bits):
        t = b.mul(xb, yb)
        x_xor_y = b.bit_xor(xb, yb)
        out.append(b.add(t, b.mul(zb, x_xor_y)))
    return out


def sha256_compress(b: CircuitBuilder, msg: List[U32Word],
                    state: List[U32Word]) -> List[U32Word]:
    """One compression block: 16 message words + 8 state words -> 8 words."""
    w = list(msg)
    for i in range(16, 64):
        s0 = word_from_bits(b, small_sigma0(b, w[i - 15]))
        s1 = word_from_bits(b, small_sigma1(b, w[i - 2]))
        w.append(add_words_mod32(b, [w[i - 16], s0, w[i - 7], s1]))

    a, bb, c, d, e, f, g, h = state
    for i in range(64):
        ch = word_from_bits(b, choose_bits(b, e, f, g))
        S1 = word_from_bits(b, big_sigma1(b, e))
        t1 = add_words_mod32(b, [h, S1, ch, w[i]], K[i])
        S0 = word_from_bits(b, big_sigma0(b, a))
        maj = word_from_bits(b, majority_bits(b, a, bb, c))
        t2 = add_words_mod32(b, [S0, maj])
        h, g, f = g, f, e
        e = add_words_mod32(b, [d, t1])
        d, c, bb = c, bb, a
        a = add_words_mod32(b, [t1, t2])

    return [add_words_mod32(b, [s, v])
            for s, v in zip(state, [a, bb, c, d, e, f, g, h])]


def translate_sha256_compression(tr, op) -> None:
    """Lower an ACIR Sha256Compression opcode (16 inputs, 8 hash values,
    8 outputs — mod.rs:155-165) onto the builder."""
    b = tr.builder
    msg = [word_from_var(b, tr.var_for_witness(fi.witness)) for fi in op.inputs]
    state = [word_from_var(b, tr.var_for_witness(fi.witness))
             for fi in op.hash_values]
    out = sha256_compress(b, msg, state)
    for word, wit in zip(out, op.outputs):
        b.assert_equal(word.value, tr.var_for_witness(wit))
