"""GF(p^2) = F[u]/(u^2 - 7) product and inverse on ``(re, im)`` tensor pairs,
and the product of listed columns of an ext pair of matrices, as plain
torch ops: the twins of ``ext_mul_kernel``, ``ext_inv_kernel`` and
``ext_prod_kernel`` in ``csrc/field.cu``, built on the plain Goldilocks ops
of ``field/gl_plain.py``.

Counterpart of ``make_ext``'s ``mul`` and ``inv`` in
``tpu_acir_prover/field/ext.py`` (``prod`` is a fold of that ``mul``).
``field/ext.py`` sends CPU tensors here and CUDA tensors to the kernels
(``kernels/field.py``).
"""

from __future__ import annotations

from . import gl_plain as gl

W = 7  # u^2 = 7


def mul(x, y):
    # (a0 + a1 u)(b0 + b1 u) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) u
    c0 = gl.add(gl.mul(x[0], y[0]), gl.mul_const(gl.mul(x[1], y[1]), W))
    c1 = gl.add(gl.mul(x[0], y[1]), gl.mul(x[1], y[0]))
    return (c0, c1)


def inv(x):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 - 7 a1^2)
    d = gl.sub(gl.sqr(x[0]), gl.mul_const(gl.sqr(x[1]), W))
    di = gl.inv(d)
    return (gl.mul(x[0], di), gl.neg(gl.mul(x[1], di)))


def prod(t, cols):
    """The product over ``cols`` of column j of the ext pair ``t`` of
    (rows, k) tensors, by a balanced fold of ``mul`` (one column: its
    views)."""
    items = [(t[0][:, c], t[1][:, c]) for c in cols]
    while len(items) > 1:
        items = [mul(items[i], items[i + 1]) if i + 1 < len(items)
                 else items[i] for i in range(0, len(items), 2)]
    return items[0]
