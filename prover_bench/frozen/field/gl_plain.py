"""Goldilocks arithmetic on ``int64`` tensors holding canonical u64 bits,
as plain torch ops: the twins of the field kernels in ``csrc/field.cu``.

Counterpart of the native-u64 ops in ``tpu_acir_prover/field/gl.py``
(``_make_gl_u64``: ``_add64``, ``_sub64``, ``_reduce128_64``, ``_mul64``),
with the same reduction steps, so every op returns the same canonical value.
``field/gl.py`` sends a CPU tensor here and a CUDA tensor to the kernels
(``kernels/field.py``), which give these functions' bits; the CPU tests and
the card's comparisons call these functions directly.

torch has no usable unsigned 64-bit type, so:

- ``int64`` add, sub and mul wrap modulo 2^64, which is what the u64 code
  relies on;
- ``>>`` sign-extends, so every right shift is followed by a mask;
- an unsigned compare flips the sign bit of both sides first.
"""

from __future__ import annotations

import torch

P = (1 << 64) - (1 << 32) + 1  # Goldilocks prime
EPS = (1 << 32) - 1          # 2^64 mod p; also -p mod 2^64
M32 = (1 << 32) - 1
_SIGN = -(1 << 63)           # sign bit as an int64 scalar
_P_FLIP = P ^ (1 << 63)      # p with its sign bit flipped, as a signed value
_P_S64 = P - (1 << 64)       # p as an int64 value


def s64(v: int) -> int:
    """A u64 value (python int in [0, 2^64)) as the int64 with its bits."""
    v = int(v) % (1 << 64)
    return v - (1 << 64) if v >= (1 << 63) else v


def const(v: int, like: torch.Tensor = None, device=None) -> torch.Tensor:
    """A 0-d tensor holding the field value ``v`` on ``like``'s device.

    A fill on the device, not a copy from the host: it neither waits for
    the device nor breaks the capture of a CUDA graph."""
    dev = like.device if like is not None else device
    return torch.full((), s64(int(v) % P), dtype=torch.int64, device=dev)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bits by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b on the u64 bits."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def canon(x: torch.Tensor) -> torch.Tensor:
    """Subtract p once where x >= p (unsigned)."""
    return torch.where((x ^ _SIGN) >= _P_FLIP, x + EPS, x)


def add(a, b):
    s = a + b
    s = torch.where(ult(s, a), s + EPS, s)
    return canon(s)


def sub(a, b):
    d = a - b
    d = torch.where(ult(a, b), d - EPS, d)
    return canon(d)


def neg(a):
    return torch.where(a == 0, torch.zeros_like(a), _P_S64 - a)


def reduce128(lo, hi):
    """(hi:lo) 128-bit value -> canonical element, using 2^64 = 2^32 - 1
    and 2^96 = -1 (mod p)."""
    x3 = shr(hi, 32)
    x2 = hi & M32
    t = lo - x3
    t = torch.where(ult(lo, x3), t - EPS, t)
    r = t + x2 * EPS
    r = torch.where(ult(r, t), r + EPS, r)
    return canon(r)


def mul_wide(a, b):
    """Full 64x64 -> 128-bit product (lo, hi) from 32-bit halves."""
    al, ah = a & M32, shr(a, 32)
    bl, bh = b & M32, shr(b, 32)
    ll = al * bl          # each partial product < 2^64; int64 wraps
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = shr(ll, 32) + (lh & M32) + (hl & M32)   # < 3 * 2^32, no wrap
    lo = (ll & M32) | (mid << 32)
    hi = hh + shr(lh, 32) + shr(hl, 32) + shr(mid, 32)
    return lo, hi


def mul(a, b):
    return reduce128(*mul_wide(a, b))


def sqr(a):
    return mul(a, a)


def mul_const(a, c: int):
    return mul(a, const(c, a))


def pow_const(a, e: int):
    """a ** e for a python-int exponent (square and multiply)."""
    e = int(e)
    r = torch.ones_like(a)
    x = a
    while e > 0:
        if e & 1:
            r = mul(r, x)
        e >>= 1
        if e:
            x = mul(x, x)
    return r


def inv(a):
    """Inverse via Fermat, a^(p-2); inv(0) = 0."""
    return pow_const(a, P - 2)
