"""Goldilocks arithmetic on ``int64`` tensors holding canonical u64 bits.

Frozen copy of the port's ``field/gl.py`` in which ``add``, ``sub``,
``mul`` and ``pow_const`` are the plain torch ops of ``gl_plain.py`` on
every device: no kernel of the port runs here.  The field constants and the
python-int scalar ops are the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from .gl_plain import add, mul, pow_const, sub  # noqa: F401
from .gl_plain import (EPS, M32, P, canon, const, mul_wide,  # noqa: F401
                       neg, reduce128, s64, shr, ult)

EPSILON = (1 << 32) - 1  # 2^64 mod p

# Multiplicative group: |F*| = p - 1 = 2^32 * 3 * 5 * 17 * 257 * 65537.
TWO_ADICITY = 32
# 7 generates F* (verified in tests against the factorization above).
MULTIPLICATIVE_GENERATOR = 7
# 7^((p-1)/2^32): a primitive 2^32-nd root of unity (computed in tests).
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> 32, P)

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


def sqr(a):
    return mul(a, a)


def mul_const(a, c: int):
    return mul(a, const(c, a))


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
