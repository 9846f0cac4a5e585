"""Port field ops (tpu_acir_prover_torch.field.gl / ext) against the JAX
package's numpy field and its python-int scalar ops, bit for bit (field
arithmetic is exact: no tolerance)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_acir_prover.field import ext as jext
from tpu_acir_prover.field import gl as jgl
from tpu_acir_prover.field.gl import P, s_inv, s_mul
from tpu_acir_prover_torch.field import ext as E
from tpu_acir_prover_torch.field import gl

torch.set_num_threads(1)

G = jgl.make_gl(np)
EXT = jext.make_ext(G)
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         1 << 63, P >> 1]


def _vals(seed, n=400):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=n, dtype=np.uint64)
    e = np.array(EDGES, dtype=np.uint64)
    return np.concatenate([v, e, np.roll(e, seed % len(EDGES))])


def _t(v):
    """A u64 array as a tensor of its shape (0-d included)."""
    return gl.from_u64(v, "cpu").reshape(np.shape(v))


def _limbs(v):
    v = np.asarray(v, dtype=np.uint64)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


# broadcast operand shapes the prover gives the field ops
BROADCAST = [((64, 5), (64, 1)), ((), (9, 4)), ((1, 8, 1), (4, 8, 3)),
             ((6, 1), (1, 7)), ((12,), ())]


def _shaped(shape, seed):
    """Canonical values of a shape from a seed, the edge values first."""
    v = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64).reshape(-1)
    k = min(v.size, len(EDGES))
    v[:k] = np.array(EDGES[:k], dtype=np.uint64)
    return v.reshape(shape)


def _sid(shape):
    return "x".join(map(str, shape)) or "0d"


def _u(t):
    """A tensor's u64 values in its shape (0-d included)."""
    return gl.to_u64(t).reshape(tuple(t.shape))


BINARY = {
    "add": (gl.add, G.add),
    "sub": (gl.sub, G.sub),
    "mul": (gl.mul, G.mul),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_matches_numpy_field(op):
    a, b = _vals(1), _vals(2)
    port, ref = BINARY[op]
    got = gl.to_u64(port(_t(a), _t(b)))
    want = G.to_u64(ref(_limbs(a), _limbs(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op", ["neg", "sqr", "inv"])
def test_unary_matches_numpy_field(op):
    a = _vals(3, n=64)
    got = gl.to_u64(getattr(gl, op)(_t(a)))
    want = G.to_u64(getattr(G, op)(_limbs(a)))
    assert np.array_equal(got, want)


def test_mul_matches_python_ints():
    a, b = _vals(4), _vals(5)
    got = gl.to_u64(gl.mul(_t(a), _t(b)))
    assert [int(x) for x in got] == [s_mul(int(x), int(y))
                                     for x, y in zip(a, b)]


def test_inv_matches_s_inv():
    a = _vals(6, n=32)
    got = gl.to_u64(gl.inv(_t(a)))
    assert [int(x) for x in got] == [s_inv(int(x)) if x else 0 for x in a]


@pytest.mark.parametrize("c,e,shape", [
    *(pytest.param(c, e, None, id=f"{c}-{e}")
      for c, e in [(7, 0), (P - 1, 1), (1 << 32, 5),
                   (12345678901234567, P - 2)]),
    *(pytest.param(12345, e, shapes[1], id=f"{e}-{_sid(shapes[1])}")
      for shapes in BROADCAST for e in [0, 1, 7, 1000003, P - 2])])
def test_mul_const_and_pow_const(c, e, shape):
    # shape None: a row of values; else the values of that shape (inv too
    # where e = p - 2)
    a = _vals(7, n=32) if shape is None else _shaped(shape, e % 97)
    assert np.array_equal(_u(gl.mul_const(_t(a), c)),
                          G.to_u64(G.mul_const(_limbs(a), c)))
    assert np.array_equal(_u(gl.pow_const(_t(a), e)),
                          G.to_u64(G.pow_const(_limbs(a), e)))
    if shape is not None and e == P - 2:
        assert np.array_equal(_u(gl.inv(_t(a))), G.to_u64(G.inv(_limbs(a))))


def test_select_eq_is_zero():
    a, b = _vals(8), _vals(9)
    ta, tb = _t(a), _t(b)
    cond = torch.from_numpy(a > b)
    assert np.array_equal(gl.to_u64(gl.select(cond, ta, tb)),
                          np.where(a > b, a, b))
    assert np.array_equal(gl.eq(ta, ta).numpy(), np.ones(a.size, bool))
    assert np.array_equal(gl.eq(ta, tb).numpy(), a == b)
    assert np.array_equal(gl.is_zero(ta).numpy(), a == 0)


def test_converters_round_trip_numpy_and_jax_limbs():
    a = _vals(10)
    t = _t(a)
    assert t.dtype == torch.int64
    assert np.array_equal(gl.to_u64(t), a)
    lo, hi = _limbs(a)
    t2 = gl.from_limbs(jnp.asarray(lo), jnp.asarray(hi), "cpu")
    assert torch.equal(t, t2)
    lo2, hi2 = gl.to_limbs(t2)
    assert np.array_equal(lo, lo2) and np.array_equal(hi, hi2)


def test_powers_and_sum_axis():
    from tpu_acir_prover.circuit.compile import powers_u64
    base = jgl.root_of_unity(9)
    assert np.array_equal(gl.to_u64(gl.powers(base, 300, "cpu")),
                          powers_u64(base, 300))
    a = _vals(11).reshape(-1, 3)
    want = [sum(int(x) for x in a[:, j]) % P for j in range(3)]
    assert [int(x) for x in gl.to_u64(gl.sum_axis(_t(a), 0))] == want


def _ext_pair(seed, n=48):
    return _vals(seed, n), _vals(seed + 100, n)


EXT_BINARY = {"add": (E.add, EXT.add), "sub": (E.sub, EXT.sub),
              "mul": (E.mul, EXT.mul)}


@pytest.mark.parametrize("op,shapes", [
    *(pytest.param(op, None, id=op) for op in sorted(EXT_BINARY)),
    *(pytest.param("mul", (sa, sb), id=f"mul-{_sid(sa)}-{_sid(sb)}")
      for sa, sb in BROADCAST)])
def test_ext_binary_matches_numpy_ext(op, shapes):
    # shapes None: rows of values; else (x0, y1) of the first shape and
    # (x1, y0) of the second, broadcast together
    if shapes is None:
        (x0, x1), (y0, y1) = _ext_pair(20), _ext_pair(21)
    else:
        sa, sb = shapes
        x0, x1, y0, y1 = (_shaped(sa, 11), _shaped(sb, 12),
                          _shaped(sb, 13), _shaped(sa, 14))
    port, ref = EXT_BINARY[op]
    got = port((_t(x0), _t(x1)), (_t(y0), _t(y1)))
    want = ref((_limbs(x0), _limbs(x1)), (_limbs(y0), _limbs(y1)))
    for g, w in zip(got, want):
        assert np.array_equal(_u(g), np.broadcast_to(G.to_u64(w), g.shape))


def test_ext_inv_pow_match_scalar_ops():
    x0, x1 = _ext_pair(22, n=8)
    inv = E.inv((_t(x0), _t(x1)))
    pw = E.pow_const((_t(x0), _t(x1)), 1000003)
    for i in range(x0.size):
        xi = (int(x0[i]), int(x1[i]))
        got_inv = (int(gl.to_u64(inv[0])[i]), int(gl.to_u64(inv[1])[i]))
        if xi != (0, 0):
            assert got_inv == jext.e_inv(xi)
        assert (int(gl.to_u64(pw[0])[i]), int(gl.to_u64(pw[1])[i])) == \
            jext.e_pow(xi, 1000003)
    # the inverse of pairs whose halves broadcast together
    for sa, sb in BROADCAST:
        x0, x1 = _shaped(sa, 11), _shaped(sb, 12)
        got = E.inv((_t(x0), _t(x1)))
        want = EXT.inv((_limbs(x0), _limbs(x1)))
        for g, w in zip(got, want):
            assert np.array_equal(_u(g),
                                  np.broadcast_to(G.to_u64(w), g.shape))


def test_ext_mul_matches_e_mul_and_powers():
    (x0, x1), (y0, y1) = _ext_pair(23), _ext_pair(24)
    got = E.mul((_t(x0), _t(x1)), (_t(y0), _t(y1)))
    for i in range(x0.size):
        assert (int(gl.to_u64(got[0])[i]), int(gl.to_u64(got[1])[i])) == \
            jext.e_mul((int(x0[i]), int(x1[i])), (int(y0[i]), int(y1[i])))
    z = (int(x0[0]), int(x1[0]))
    re, im = E.powers(z, 37, "cpu")
    for k in range(37):
        assert (int(gl.to_u64(re)[k]), int(gl.to_u64(im)[k])) == \
            jext.e_pow(z, k)


def test_ext_unary_select_eq_is_zero():
    x0, x1 = _ext_pair(25)
    x = (_t(x0), _t(x1))
    ref = (_limbs(x0), _limbs(x1))
    for port, want in ((E.neg(x), EXT.neg(ref)), (E.sqr(x), EXT.sqr(ref))):
        for g, w in zip(port, want):
            assert np.array_equal(gl.to_u64(g), G.to_u64(w))
    z = E.from_base(torch.zeros_like(x[0]))
    assert bool(E.is_zero(z).all()) and bool(E.eq(x, x).all())
    assert np.array_equal(E.is_zero(x).numpy(), (x0 == 0) & (x1 == 0))
    cond = torch.from_numpy(x0 > x1)
    sel = E.select(cond, x, z)
    assert np.array_equal(gl.to_u64(sel[1]), np.where(x0 > x1, x1, 0))
