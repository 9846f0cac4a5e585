"""GF(p^2) = F[u]/(u^2 - 7) product and inverse on ``(re, im)`` tensor pairs,
and the products (and leave-one-out sums) of groups of columns of an ext
pair of matrices, as plain torch ops: the twins of ``ext_mul_kernel``,
``ext_inv_kernel`` and ``ext_prod_kernel`` in ``csrc/field.cu``, built on
the plain Goldilocks ops of ``field/gl_plain.py``.

Counterpart of ``make_ext``'s ``mul`` and ``inv`` in
``tpu_acir_prover/field/ext.py``; ``group_prod`` computes what
``grouped_fold`` and ``_axis_excl_products`` do in
``tpu_acir_prover/prover/prove.py``, by the definition.
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


def _product(items):
    """A balanced fold of ``mul`` over a non-empty list of ext values."""
    while len(items) > 1:
        items = [mul(items[i], items[i + 1]) if i + 1 < len(items)
                 else items[i] for i in range(0, len(items), 2)]
    return items[0]


def group_prod(t, groups, allbut=False):
    """For each (start, end) of ``groups``, the product of those columns of
    the ext pair ``t`` of (rows, k) tensors (one column: its views); with
    ``allbut`` also (products, sums): each group's sum over its columns i
    of the product of the others, 1 for a group of one column."""
    cols = [[(t[0][:, c], t[1][:, c]) for c in range(s, e)]
            for s, e in groups]
    prods = [_product(items) for items in cols]
    if not allbut:
        return prods
    sums = []
    for items in cols:
        if len(items) == 1:
            one = gl.const(1, items[0][0]).expand_as(items[0][0])
            sums.append((one, gl.const(0, one).expand_as(one)))
            continue
        total = None
        for i in range(len(items)):
            term = _product(items[:i] + items[i + 1:])
            total = term if total is None else (gl.add(total[0], term[0]),
                                                gl.add(total[1], term[1]))
        sums.append(total)
    return prods, sums
