"""Quadratic extension GF(p^2) = F[u]/(u^2 - 7) on ``(re, im)`` tensor pairs.

Counterpart of ``make_ext`` in ``tpu_acir_prover/field/ext.py``; the host
scalar ops ``e_add`` .. ``e_pow`` on python-int pairs are copies of that
module's.  ``mul``, ``inv`` and ``group_prod`` go through
``kernels/field.py``: CUDA tensors to ``ext_mul_kernel`` /
``ext_inv_kernel`` / ``ext_prod_kernel``, CPU tensors to their plain twins
in ``field/ext_plain.py``; the other ops are built on those and on
``field/gl.py``'s.
"""

from __future__ import annotations

import torch

from ..kernels import field as _kf
from . import gl
from .ext_plain import W  # noqa: F401


def const(v, like: torch.Tensor):
    """Ext scalar (python-int pair) -> pair of 0-d tensors."""
    return (gl.const(v[0], like), gl.const(v[1], like))


def from_base(a):
    return (a, torch.zeros_like(a))


def add(x, y):
    return (gl.add(x[0], y[0]), gl.add(x[1], y[1]))


def sub(x, y):
    return (gl.sub(x[0], y[0]), gl.sub(x[1], y[1]))


def neg(x):
    return (gl.neg(x[0]), gl.neg(x[1]))


def mul(x, y):
    """(a0 + a1 u)(b0 + b1 u) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) u."""
    return _kf.ext_mul(x, y)


def mul_base(x, b):
    return (gl.mul(x[0], b), gl.mul(x[1], b))


def sqr(x):
    return mul(x, x)


def inv(x):
    """1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 - 7 a1^2); inv(0) = 0."""
    return _kf.ext_inv(x)


def group_prod(t, groups, allbut=False):
    """For each (start, end) of ``groups`` (at most 8 disjoint ranges of at
    most 8 columns), the product of those columns of the ext pair ``t`` of
    (rows, k <= 16) tensors as (rows,) ext values; with ``allbut``
    (products, sums), each sum over a group's columns i of the product of
    the others (1 for one column)."""
    return _kf.ext_prod(t, groups, allbut)


def pow_const(x, e: int):
    e = int(e)
    r = (torch.ones_like(x[0]), torch.zeros_like(x[1]))
    b = x
    while e > 0:
        if e & 1:
            r = mul(r, b)
        e >>= 1
        if e:
            b = mul(b, b)
    return r


def select(cond, x, y):
    return (torch.where(cond, x[0], y[0]), torch.where(cond, x[1], y[1]))


def eq(x, y):
    return (x[0] == y[0]) & (x[1] == y[1])


def is_zero(x):
    return (x[0] == 0) & (x[1] == 0)


def powers_table(z, n: int):
    """[z^0 .. z^(n-1)] as an ext pair of (n,) tensors, for an ext scalar z
    held on the device (a pair of 0-d tensors), by log-doubling."""
    re = torch.ones(1, dtype=torch.int64, device=z[0].device)
    im = torch.zeros_like(re)
    cur = z
    while re.shape[0] < n:
        nre, nim = mul((re, im), cur)
        re, im = torch.cat([re, nre]), torch.cat([im, nim])
        cur = mul(cur, cur)
    return re[:n], im[:n]


def powers(z, n: int, device):
    """[z^0 .. z^(n-1)] for an ext scalar z given as a python-int pair."""
    return powers_table((gl.const(z[0], device=device),
                         gl.const(z[1], device=device)), n)


def dot(ys, alphas):
    """sum_i alphas_i * ys_i over ext pairs of (k,) tensors -> an ext scalar
    (pair of 0-d tensors): one vector multiply, then a halving sum."""
    return tuple(gl.sum_axis(c) for c in mul(ys, alphas))


# Host scalar extension ops on python-int pairs (for the challenger/verifier).

def e_add(x, y):
    return ((x[0] + y[0]) % gl.P, (x[1] + y[1]) % gl.P)


def e_sub(x, y):
    return ((x[0] - y[0]) % gl.P, (x[1] - y[1]) % gl.P)


def e_mul(x, y):
    p = gl.P
    return ((x[0] * y[0] + W * x[1] * y[1]) % p, (x[0] * y[1] + x[1] * y[0]) % p)


def e_inv(x):
    p = gl.P
    d = (x[0] * x[0] - W * x[1] * x[1]) % p
    di = pow(d, p - 2, p)
    return ((x[0] * di) % p, (-x[1] * di) % p)


def e_pow(x, e):
    r = (1, 0)
    b = x
    while e > 0:
        if e & 1:
            r = e_mul(r, b)
        b = e_mul(b, b)
        e >>= 1
    return r
