"""Goldilocks arithmetic on ``int64`` tensors holding canonical u64 bits.

Counterpart of the native-u64 ops in ``tpu_acir_prover/field/gl.py``
(``_make_gl_u64``: ``_add64``, ``_sub64``, ``_reduce128_64``, ``_mul64``),
with the same reduction steps, so every op returns the same canonical value.
The field constants and the python-int scalar ops at the end are copies of
that module's; its numpy ``(lo, hi)`` namespace is ``field/gl_np.py``.

torch has no usable unsigned 64-bit type, so:

- ``int64`` add, sub and mul wrap modulo 2^64, which is what the u64 code
  relies on;
- ``>>`` sign-extends, so every right shift is followed by a mask;
- an unsigned compare flips the sign bit of both sides first.
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1  # Goldilocks prime
EPSILON = (1 << 32) - 1  # 2^64 mod p

# Multiplicative group: |F*| = p - 1 = 2^32 * 3 * 5 * 17 * 257 * 65537.
TWO_ADICITY = 32
# 7 generates F* (verified in tests against the factorization above).
MULTIPLICATIVE_GENERATOR = 7
# 7^((p-1)/2^32): a primitive 2^32-nd root of unity (computed in tests).
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> 32, P)

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


def from_u64(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array with the same bits (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def from_limbs(lo, hi, device) -> torch.Tensor:
    """(lo, hi) uint32 arrays (numpy or JAX) -> int64 tensor."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return from_u64((hi << np.uint64(32)) | lo, device)


def to_limbs(t: torch.Tensor):
    """int64 tensor -> (lo, hi) numpy uint32 arrays."""
    v = to_u64(t)
    return ((v & np.uint64(M32)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


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


def select(cond, a, b):
    return torch.where(cond, a, b)


def eq(a, b):
    return a == b


def is_zero(a):
    return a == 0


def powers(base: int, n: int, device) -> torch.Tensor:
    """[base^0 .. base^(n-1)] on the device by log-doubling."""
    out = torch.ones(1, dtype=torch.int64, device=device)
    cur = int(base) % P
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, const(cur, out))])
        cur = cur * cur % P
    return out[:n]


def sum_axis(x, dim: int = 0):
    """Field sum over one axis by pairwise halving."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = add(x[:h], x[h:2 * h])
        x = torch.cat([s, x[2 * h:]]) if x.shape[0] % 2 else s
    return x[0]


# ---------------------------------------------------------------------------
# Host scalar ops on python ints (for the Fiat-Shamir challenger, twiddle
# precomputation and small host-side math).


def s_add(a: int, b: int) -> int:
    return (a + b) % P


def s_sub(a: int, b: int) -> int:
    return (a - b) % P


def s_mul(a: int, b: int) -> int:
    return (a * b) % P


def s_inv(a: int) -> int:
    return pow(a, P - 2, P)


def s_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity."""
    assert 0 <= log_n <= TWO_ADICITY
    g = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - log_n):
        g = (g * g) % P
    return g
